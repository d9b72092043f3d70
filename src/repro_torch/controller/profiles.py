"""Paper-calibrated backbone profiles (Table 3 + Fig. 12 saturation points).

Derivation notes:
  * l(1) from Table 3 mean per-request backbone latency;
  * beta chosen so saturated shared-backbone throughput matches Fig. 12
    (FMplex sustains ~84 RPS on MOMENT-Large where S-STFQ caps at 1/l(1)≈38);
  * memory/load times straight from Table 3 (backbone vs task split).
"""
from __future__ import annotations

from repro_torch.core.profile import FMProfile

MB = 1 << 20

PAPER_PROFILES: dict[str, FMProfile] = {
    # Time series
    "moment-large": FMProfile("moment-large", alpha=16.8e-3, beta=11.2e-3,
                              b_max=16, memory_bytes=1462 * MB,
                              load_time_s=5.737, adapter_alpha=2e-3,
                              adapter_beta=4e-4, task_memory_bytes=int(0.52 * MB),
                              task_load_s=0.025),
    "papagei": FMProfile("papagei", alpha=11e-3, beta=4.8e-3, b_max=16,
                         memory_bytes=int(23.24 * MB), load_time_s=0.162,
                         adapter_alpha=1e-3, adapter_beta=2e-4,
                         task_memory_bytes=int(0.26 * MB), task_load_s=0.005),
    # Vision
    "dinov2-base": FMProfile("dinov2-base", alpha=13e-3, beta=5.8e-3, b_max=16,
                             memory_bytes=347 * MB, load_time_s=0.817,
                             adapter_alpha=1.5e-3, adapter_beta=3e-4,
                             task_memory_bytes=int(0.03 * MB), task_load_s=0.001),
    "swin-large": FMProfile("swin-large", alpha=21e-3, beta=9.9e-3, b_max=16,
                            memory_bytes=347 * MB, load_time_s=1.001,
                            adapter_alpha=1.5e-3, adapter_beta=3e-4,
                            task_memory_bytes=int(0.04 * MB), task_load_s=0.001),
    # LLM / VLM (token-based; service time charged per request-equivalent)
    "qwen2.5-3b": FMProfile("qwen2.5-3b", alpha=120e-3, beta=190e-3, b_max=4,
                            memory_bytes=6285 * MB, load_time_s=3.095,
                            adapter_alpha=4e-3, adapter_beta=1e-3,
                            task_memory_bytes=8 * MB, task_load_s=0.18),
    "mistral-7b": FMProfile("mistral-7b", alpha=220e-3, beta=384e-3, b_max=4,
                            memory_bytes=14496 * MB, load_time_s=5.927,
                            adapter_alpha=4e-3, adapter_beta=1e-3,
                            task_memory_bytes=8 * MB, task_load_s=0.2),
    "qwen2-vl-2b": FMProfile("qwen2-vl-2b", alpha=60e-3, beta=74e-3, b_max=8,
                             memory_bytes=4420 * MB, load_time_s=4.492,
                             adapter_alpha=4e-3, adapter_beta=1e-3,
                             task_memory_bytes=int(8.76 * MB), task_load_s=0.176),
}


def get_profile(name: str) -> FMProfile:
    return PAPER_PROFILES[name]
