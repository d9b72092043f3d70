"""Config registry of the PyTorch port: importing this package registers the
architectures the port serves so far (a copy of ``configs/base.py`` and of
each architecture's file, kept in step with the JAX package by hand)."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, reduced, register
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    h2o_danube_1_8b,
    minitron_8b,
    moment_large,
    qwen2_7b,
    qwen2_vl_72b,
    stablelm_1_6b,
    whisper_base,
)

__all__ = ["ModelConfig", "get_config", "list_configs", "reduced", "register"]
