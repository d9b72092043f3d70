"""End-to-end fault-tolerant training on a ~125M-class architecture with
the PyTorch port (xlstm-125m reduced; pass --full-width for the real width
at short depth), the twin of ``examples/train_e2e.py``: checkpoint/restart,
failure injection and straggler detection from
``repro_torch.launch.train``, on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/train_e2e_torch.py --steps 60
  PYTHONPATH=src python examples/train_e2e_torch.py --device cpu --steps 30
"""
import argparse
import dataclasses
import tempfile

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.distributed.fault import FailureInjector
from repro_torch.launch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--fail-at", type=int, default=25,
                    help="inject a node failure at this step (-1 = off)")
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.full_width:
        cfg = dataclasses.replace(cfg, num_layers=4)   # full width, short depth
    else:
        cfg = reduced(cfg)

    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(cfg, batch=args.batch, seq=args.seq, ckpt_dir=ckpt_dir,
                     ckpt_every=10, lr=1e-3, total_steps=args.steps,
                     device=args.device)
        inj = FailureInjector(args.fail_at if args.fail_at >= 0 else None)
        losses = tr.run(args.steps, injector=inj)
        print(f"arch={cfg.name} steps={len(losses)} "
              f"loss {losses[0]:.3f} -> {np.mean(losses[-5:]):.3f} "
              f"(restarted={inj.fired}, stragglers={len(tr.straggler.events)})")
        assert np.mean(losses[-5:]) < losses[0], "loss must decrease"
    return losses, inj


if __name__ == "__main__":
    main()
