#!/usr/bin/env python3
"""K5's case table and ``chip_smoke.phase_long`` alone, on one GPU.

    python3 tools/long_probe.py

Builds the kernels, starts the long phase's dry-run cells on the host,
checks K5 at every case of ``chip_smoke.FLOAT_CASES`` and runs
``phase_long`` (K5 at the long_500k shapes and in 16 pieces, decode at
524288 positions, xlstm-125m training at 2 x 4096, a Mamba layer's peak
memory, the dry-run cells). Prints each phase's result and the card's
name and power limit; exits non-zero if any failed. Needs a CUDA GPU and
nvcc.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.build_all()
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    cs.log("ptxas decode_attention: " + ", ".join(
        f"{k}: {r}, {sp}" for k, r, sp in cs.ptxas_kernels("decode_attention")))
    dev = torch.device("cuda", 0)
    dryrun = cs.long_dryrun_start()
    ok, _ = cs.check_float_decode(dev,
                                  torch.Generator(device=dev).manual_seed(5))
    phases, _ = cs.phase_long(dev, dryrun)
    phases["float_cases"] = ok
    cs.log(json.dumps(phases, default=str))
    cs.log(f"total {time.perf_counter() - t0:.1f} s")
    print(cs.smi_line(), flush=True)
    return 0 if all(phases.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
