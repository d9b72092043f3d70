"""Quickstart on the PyTorch port: build, fine-tune and package an FMplex
task pipeline (paper Listing 1/2) against a MOMENT-style backbone. The
backbone is frozen; the encoder, the decoder and the q/v adapter train
through the port's attention and norm kernels and their backward kernels.

  PYTHONPATH=src python examples/quickstart_torch.py        # the card, full width
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu --reduced
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.taskapi import (Adapter, LinearChannelCombiner, MLPDecoder,
                                 Pipeline, vFM)
from repro_torch.taskapi.artifacts import serialize, task_spec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the backbone runs (default: the card)")
    ap.add_argument("--reduced", action="store_true",
                    help="the 2-layer, d 64 cut of moment-large (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args(argv)

    # 1. a vFM handle over the backbone
    cfg = get_config("moment-large")
    if args.reduced:
        cfg = reduced(cfg)
    P = Pipeline(vFM(cfg, device=args.device), task_id="heart_rate")

    # 2. compose the task pipeline (paper Listing 1)
    P.add_encoder(LinearChannelCombiner(num_channels=3, new_num_channels=1,
                                        patch=8, d_model=cfg.d_model))
    P.add_decoder(MLPDecoder(input_dim=cfg.d_model, hidden_dim=64,
                             output_dim=1))
    P.attach_adapter(Adapter(rank=4, adapter_id="hr_lora"))

    # 3. fine-tune extensions; the shared backbone stays frozen (Listing 2)
    rng = np.random.RandomState(0)

    def data():
        while True:
            x = rng.randn(16, 64, 3).astype(np.float32)   # (B, T, channels)
            y = (x[:, :, 0].mean(axis=1) * 5.0 + 1.0)[:, None]
            yield x, y

    losses = P.train(data(), steps=args.steps, lr=5e-3, loss="mse",
                     verbose=True)
    print(f"loss: {losses[0]:.4f} -> {min(losses[-10:]):.4f}")

    # 4. inference through the pipeline
    y = P.run(rng.randn(4, 64, 3).astype(np.float32))
    print("predictions:", y.cpu().numpy().ravel())

    # 5. package as a deployment artifact for FMplex-Controller
    art = P.package(weight=2.0, slo_s=0.2, demand_rps=5.0)
    blob = serialize(art)
    print(f"artifact: {len(blob)} bytes, spec={task_spec(art)}")
    return losses


if __name__ == "__main__":
    main()
