"""Device meshes (``torch.distributed`` ``DeviceMesh``).

Functions, not module constants, so importing this module starts no process
group. A mesh needs a process group of as many ranks as it has devices:
``make_local_mesh`` starts a 1-rank group itself where none is up;
``make_production_mesh`` is meant for the dry-run's fake group of 256 or
512 ranks (``launch/dryrun.py``), the counterpart of the JAX package's
512 forced host devices.
"""
from __future__ import annotations

import os
import tempfile

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

_BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the dimension names ``axes`` on
    the running process group (whose world size is ``prod(shape)``)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(device_type: str = "cuda"):
    """A (1, 1) mesh over ("data", "model"), the single-pod dimension
    names, on a 1-rank group. Where no group is up it starts one (NCCL on
    the card, gloo on the CPU) over a ``FileStore`` in a fresh temporary
    directory: loopback only, no port."""
    if not dist.is_initialized():
        store = dist.FileStore(os.path.join(
            tempfile.mkdtemp(prefix="repro_mesh_"), "store"), 1)
        if device_type == "cuda":
            import torch
            torch.cuda.set_device(0)
        dist.init_process_group(_BACKEND[device_type], store=store, rank=0,
                                world_size=1)
    return make_mesh((1, 1), ("data", "model"), device_type)


def make_mesh_for(devices: int, model_parallel: int = 16, pods: int = 1,
                  device_type: str = "cuda"):
    """Elastic-scaling helper: build a mesh for an arbitrary device count."""
    data = devices // (model_parallel * pods)
    assert data >= 1 and data * model_parallel * pods == devices, (devices, model_parallel, pods)
    if pods > 1:
        return make_mesh((pods, data, model_parallel),
                         ("pod", "data", "model"), device_type)
    return make_mesh((data, model_parallel), ("data", "model"), device_type)
