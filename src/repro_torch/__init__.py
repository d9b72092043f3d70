"""PyTorch/CUDA port of the FMplex reproduction.

Mirrors the layout of the JAX package (``configs/``, ``models/``,
``kernels/``, ``core/``, ``serving/``) module for module, so each file has a
counterpart of the same name. Imports ``torch`` and numpy only. Entry points
take an explicit ``device`` (default ``"cuda"``); the hand-written Hopper
kernels live in ``csrc/`` and are built on first use by ``kernels.build``.
"""
