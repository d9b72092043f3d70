#!/usr/bin/env python3
"""K5's and K3's case tables and ``chip_smoke.phase_long`` alone, on one
GPU.

    python3 tools/long_probe.py                  # everything below
    python3 tools/long_probe.py --only long_k3   # K3 at the long_500k shapes

Builds the kernels, starts the long phase's dry-run cells on the host,
checks K5 at every case of ``chip_smoke.FLOAT_CASES`` and K3/K4 at every
case of ``chip_smoke.INT8_CASES``, and runs ``phase_long`` (K5 and K3 at
the long_500k shapes and in 16 pieces, decode at 524288 positions on a
float and an int8 cache, xlstm-125m training at 2 x 4096, a Mamba layer's
peak memory, the dry-run cells). ``--only long_k3`` or ``--only long_k5``
runs that check alone (no dry-run cells). Prints each phase's result, the
ptxas report of the decode kernels and the card's name and power limit;
exits non-zero if any failed. Needs a CUDA GPU and nvcc.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    import torch

    from repro_torch.kernels import build
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("long_k3", "long_k5"))
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    for name in ("decode_attention", "decode_attention_int8"):
        cs.log(f"ptxas {name}: " + ", ".join(
            f"{k}: {r}, {sp}" for k, r, sp in cs.ptxas_kernels(name)))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(53)
    if args.only:
        ok, stats = getattr(cs, args.only)(dev, gen)
        phases = {args.only: ok}
        cs.log(json.dumps(stats, default=float))
    else:
        dryrun = cs.long_dryrun_start()
        ok, _ = cs.check_float_decode(dev, gen)
        ok8, _ = cs.check_int8_decode(dev, gen)
        phases, _ = cs.phase_long(dev, dryrun)
        phases["float_cases"], phases["int8_cases"] = ok, ok8
    cs.log(json.dumps(phases, default=str))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    print(cs.smi_line(), flush=True)
    return 0 if all(phases.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
