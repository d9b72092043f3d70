"""Deployment artifacts: the unit FMplex-Controller consumes (paper §4.3).

An artifact = pipeline spec + extension weights + task metadata (backbone id,
fair-share weight, SLO, expected demand). Serialized as npz + JSON-compatible
metadata, the JAX package's wire format, so artifacts survive process and
server boundaries and cross between the two packages either way.
"""
from __future__ import annotations

import io
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.models.common import tree_paths


def _flatten(tree) -> dict[str, np.ndarray]:
    """``/``-joined path -> numpy leaf (the JAX package's keys)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree_paths(tree)}


def package_pipeline(pipeline, *, weight: float = 1.0,
                     slo_s: Optional[float] = None,
                     demand_rps: float = 1.0) -> dict:
    meta = {
        "task_id": pipeline.task_id,
        "backbone": pipeline.vfm.cfg.name,
        "weight": weight,
        "slo_s": slo_s,
        "demand_rps": demand_rps,
        "adapter_id": (pipeline.adapter.adapter_id if pipeline.adapter else None),
        "adapter_rank": (pipeline.adapter.rank if pipeline.adapter else None),
        "has_encoder": pipeline.encoder is not None,
        "has_decoder": pipeline.decoder is not None,
    }
    return {
        "meta": meta,
        "encoder_weights": _flatten(pipeline.state.get("encoder")),
        "decoder_weights": _flatten(pipeline.state.get("decoder")),
        "adapter_tree": pipeline.state.get("adapter"),   # tree (in-process)
        "encoder": pipeline.encoder,
        "decoder": pipeline.decoder,
    }


def serialize(artifact: dict) -> bytes:
    """npz-serialize weights + JSON metadata (wire format)."""
    buf = io.BytesIO()
    arrays = {}
    for k, v in artifact["encoder_weights"].items():
        arrays[f"enc/{k}"] = v
    for k, v in artifact["decoder_weights"].items():
        arrays[f"dec/{k}"] = v
    for k, v in _flatten(artifact["adapter_tree"]).items():
        arrays[f"ada/{k}"] = v
    arrays["__meta__"] = np.frombuffer(
        json.dumps(artifact["meta"]).encode(), dtype=np.uint8)
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def deserialize(blob: bytes) -> dict:
    with np.load(io.BytesIO(blob), allow_pickle=False) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        groups = {"enc": {}, "dec": {}, "ada": {}}
        for k in data.files:
            if k == "__meta__":
                continue
            g, rest = k.split("/", 1)
            groups[g][rest] = data[k]
    return {"meta": meta, "encoder_weights": groups["enc"],
            "decoder_weights": groups["dec"], "adapter_weights": groups["ada"]}


def task_spec(artifact: dict) -> dict:
    """Controller-facing task descriptor from an artifact."""
    m = artifact["meta"]
    return {"task_id": m["task_id"], "backbone": m["backbone"],
            "weight": m["weight"], "slo_s": m["slo_s"],
            "demand_rps": m["demand_rps"], "adapter_id": m["adapter_id"]}
