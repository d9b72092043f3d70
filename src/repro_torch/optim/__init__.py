from repro_torch.optim.adamw import AdamW, AdamWState, cosine_schedule, global_norm  # noqa
