"""Config registry of the PyTorch port: importing this package registers the
architectures the port serves so far (a copy of ``configs/base.py`` and of
each architecture's file, kept in step with the JAX package by hand)."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced, register
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    grok_1_314b,
    h2o_danube_1_8b,
    jamba_v0_1_52b,
    minitron_8b,
    moment_large,
    olmoe_1b_7b,
    qwen2_7b,
    qwen2_vl_72b,
    stablelm_1_6b,
    whisper_base,
    xlstm_125m,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable, grid

ASSIGNED = [
    "xlstm-125m", "whisper-base", "h2o-danube-1.8b", "minitron-8b", "qwen2-7b",
    "stablelm-1.6b", "qwen2-vl-72b", "olmoe-1b-7b", "grok-1-314b", "jamba-v0.1-52b",
]

__all__ = [
    "ModelConfig", "get_config", "list_configs", "reduced", "register",
    "SHAPES", "ShapeSpec", "applicable", "grid", "ASSIGNED",
]
