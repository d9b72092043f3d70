"""whisper-base — enc-dec audio backbone, conv frontend stubbed [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,                # decoder layers
    encoder_layers=6,
    is_encoder_decoder=True,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    frontend_stub="audio_frames",   # input_specs() supplies precomputed frame embeddings
    source="arXiv:2212.04356; unverified",
))
