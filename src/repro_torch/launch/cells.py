"""Build (step_fn, args, shardings) for every (arch × shape × mesh) cell.

The single source of the port's dry-run (``launch.dryrun``) and roofline
(``launch.roofline``). No memory is ever allocated: every input is a DTensor
whose local shard is a meta tensor of this rank's shape
(``DTensor.from_local(..., shape=, stride=)``), on a mesh of a fake process
group; ``trace_cell`` runs the step once under ``optrace.OpTrace``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs import ShapeSpec, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import optrace
from repro_torch.models import lm
from repro_torch.models.common import (ShardCtx, logical_axes, shape_structs,
                                       tree_leaves, tree_map)
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.sharding import rules as R

# archs whose weights need 2D (data+model) sharding even at serve time to fit HBM
BIG_SERVE = {"grok-1-314b", "qwen2-vl-72b"}

# gradient-accumulation microbatches for the train_4k cell (activation
# footprint scales 1/n while the global batch is preserved)
MICROBATCH = {"grok-1-314b": 4, "qwen2-vl-72b": 4, "jamba-v0.1-52b": 4,
              "xlstm-125m": 2, "whisper-base": 2}


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    fn: object                  # python callable, run once by trace_cell
    args: tuple                 # trees of meta DTensors
    in_shardings: tuple         # trees of (mesh, placements)
    out_shardings: object
    donate: tuple
    static: dict


def _rules_for(cfg: ModelConfig, shape: ShapeSpec, overrides: Optional[dict] = None):
    long_ctx = shape.name == "long_500k"
    if shape.kind == "train":
        param_rules = R.LONG_CTX_FSDP if long_ctx else R.FSDP_RULES
    elif cfg.name in BIG_SERVE:
        param_rules = R.LONG_CTX_FSDP if long_ctx else R.FSDP_RULES
    else:
        param_rules = R.LONG_CTX_PARAM if long_ctx else R.TP_RULES
    act_rules = R.LONG_CTX_ACT if long_ctx else R.ACT_RULES
    if shape.kind == "train":
        # sequence-parallel residual stream: the per-device activation
        # footprint at 4k x 256 batch
        act_rules = dict(act_rules, seq="model")
    if overrides:
        param_rules = dict(param_rules, **overrides.get("param", {}))
        act_rules = dict(act_rules, **overrides.get("act", {}))
    return param_rules, act_rules


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_structs(cfg: ModelConfig, B: int, S: int, kind: str):
    d = cfg.d_model
    bf16, i32 = torch.bfloat16, torch.int32
    s, axes = {}, {}
    if kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            s["enc_embeds"] = _meta((B, S, d), bf16)
            axes["enc_embeds"] = ("batch", None, None)
            s["tokens"] = _meta((B, S), i32)
            axes["tokens"] = ("batch", None)
        elif cfg.frontend_stub:
            s["embeds"] = _meta((B, S, d), bf16)
            axes["embeds"] = ("batch", None, None)
            if cfg.vocab_size > 0 and kind == "train":
                s["labels"] = _meta((B, S), i32)
                axes["labels"] = ("batch", None)
            if cfg.mrope_sections:
                s["pos3"] = _meta((B, S, 3), i32)
                axes["pos3"] = ("batch", None, None)
        else:
            s["tokens"] = _meta((B, S), i32)
            axes["tokens"] = ("batch", None)
    else:  # decode
        s["tokens"] = _meta((B,), i32)
        axes["tokens"] = ("batch",)
    return s, axes


def meta_dtensor(struct, sharding):
    """A DTensor of ``struct``'s global shape and dtype whose local shard
    (this rank's ``local_slices``) is a meta tensor."""
    mesh, pl = sharding
    local = R.local_slices(struct.shape, mesh, pl)
    return R.from_local(_meta([s.stop - s.start for s in local],
                              struct.dtype), mesh, pl, struct.shape)


def _place(structs, shardings):
    return tree_map(meta_dtensor, structs, shardings)


def build_cell(arch: str, shape: ShapeSpec, mesh, overrides: Optional[dict] = None) -> Cell:
    from repro_torch.sharding.padding import pad_for_tp
    model = R.mesh_dims(mesh).get("model", 1)
    cfg = pad_for_tp(get_config(arch), model)
    if overrides and "moe_dispatch" in overrides:
        cfg = dataclasses.replace(cfg, moe_dispatch=overrides["moe_dispatch"])
    elif cfg.uses_moe:
        # expert parallelism by default (falls back to gshard where
        # num_experts doesn't divide the model dimension, e.g. grok)
        cfg = dataclasses.replace(cfg, moe_dispatch="ep")
    param_rules, act_rules = _rules_for(cfg, shape, overrides)
    shard = ShardCtx(act_rules, mesh)
    B, S = shape.global_batch, shape.seq_len

    mspec = lm.model_spec(cfg)
    p_axes = logical_axes(mspec)

    def psh(rules, struct_tree, axes_tree):
        return R.tree_shardings(rules, axes_tree, mesh, struct_tree)

    def bsh(structs, axes):
        return {k: (mesh, R.placements_for(R.spec_for(
            act_rules, axes[k], mesh, tuple(structs[k].shape)), mesh))
            for k in structs}

    if shape.kind == "train":
        p_structs = shape_structs(mspec, dtype=torch.float32)
        p_sh = psh(param_rules, p_structs, p_axes)
        opt = AdamW(lr=1e-4)
        opt_structs = AdamWState(_meta((), torch.int32), p_structs, p_structs)
        opt_sh = AdamWState(None, p_sh, p_sh)
        state_structs = {"params": p_structs, "opt": opt_structs}
        state_sh = {"params": p_sh, "opt": opt_sh}
        b_structs, b_axes = _batch_structs(cfg, B, S, "train")
        b_sh = bsh(b_structs, b_axes)
        n_micro = (overrides or {}).get("microbatch", MICROBATCH.get(arch, 1))
        params = tree_map(lambda t: t.requires_grad_(True),
                          _place(p_structs, p_sh))
        state = {"params": params,
                 "opt": AdamWState(_meta((), torch.int32),
                                   _place(p_structs, p_sh),
                                   _place(p_structs, p_sh))}

        def train_step(state, batch):
            params = state["params"]
            leaves = tree_leaves(params)
            # gradient accumulation: each rank's rows in n_micro slices,
            # the gradients summed in f32 / n_micro
            micro = [{k: _local_chunk(v, n_micro, i) for k, v in batch.items()}
                     for i in range(n_micro)]
            grads, loss = None, 0.0
            for mb in micro:
                l, _ = lm.loss_fn(params, cfg, mb, shard)
                g = torch.autograd.grad(l, leaves, allow_unused=True)
                g = [torch.zeros_like(p) if x is None else x.float() / n_micro
                     for p, x in zip(leaves, g)]
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
                loss = loss + l.detach() / n_micro
            it = iter(grads)
            grads = tree_map(lambda _: next(it), params)
            with torch.no_grad():
                new_p, new_opt, om = opt.update(grads, state["opt"], params)
            return {"params": new_p, "opt": new_opt}, {"loss": loss, **om}

        return Cell(arch, shape, train_step,
                    (state, _place(b_structs, b_sh)), (state_sh, b_sh),
                    ({"params": p_sh, "opt": opt_sh}, R.replicated(mesh)),
                    (0,), {"microbatch": n_micro})

    # serving cells: params in bf16
    p_structs = shape_structs(mspec, dtype=torch.bfloat16)
    p_sh = psh(param_rules, p_structs, p_axes)
    c_spec = lm.cache_spec(cfg, B, S)
    c_structs = shape_structs(c_spec)
    c_sh = psh(param_rules, c_structs, logical_axes(c_spec))
    params = _place(p_structs, p_sh)
    cache = _place(c_structs, c_sh)

    if shape.kind == "prefill":
        b_structs, b_axes = _batch_structs(cfg, B, S, "prefill")
        b_sh = bsh(b_structs, b_axes)
        logits_sh = (mesh, R.placements_for(R.spec_for(
            act_rules, ("batch", "vocab"), mesh,
            (B, max(cfg.vocab_size, cfg.d_model))), mesh))

        def prefill_step(params, batch, cache):
            return lm.prefill(params, cfg, cache=cache, shard=shard, **batch)

        return Cell(arch, shape, prefill_step,
                    (params, _place(b_structs, b_sh), cache),
                    (p_sh, b_sh, c_sh), (logits_sh, c_sh), (2,), {})

    # decode
    b_structs, b_axes = _batch_structs(cfg, B, S, "decode")
    b_sh = bsh(b_structs, b_axes)
    batch = _place(b_structs, b_sh)
    logits_sh = (mesh, R.placements_for(R.spec_for(
        act_rules, ("batch", "vocab"), mesh, (B, cfg.vocab_size)), mesh))

    lora_cfg = (overrides or {}).get("lora")
    if lora_cfg:
        # FMplex-integrated serving: the co-batch carries per-request adapter
        # ids; the shared backbone applies multi-adapter LoRA deltas (the
        # gather path, as the JAX package's cell)
        from repro_torch.models import lora as lora_mod
        l_spec = lora_mod.lora_spec(cfg, lora_cfg.get("num_adapters", 32),
                                    lora_cfg.get("rank", 16))
        l_structs = shape_structs(l_spec, dtype=torch.bfloat16)
        l_sh = psh(param_rules, l_structs, logical_axes(l_spec))
        aidx_struct = _meta((B,), torch.int32)
        aidx_sh = (mesh, R.placements_for(R.spec_for(
            act_rules, ("batch",), mesh, (B,)), mesh))

        def serve_step_lora(params, cache, batch, lora, adapter_idx):
            return lm.decode_step(params, cfg, cache=cache, shard=shard,
                                  lora=lora, adapter_idx=adapter_idx, **batch)

        return Cell(arch, shape, serve_step_lora,
                    (params, cache, batch, _place(l_structs, l_sh),
                     meta_dtensor(aidx_struct, aidx_sh)),
                    (p_sh, c_sh, b_sh, l_sh, aidx_sh), (logits_sh, c_sh),
                    (1,), {})

    def serve_step(params, cache, batch):
        return lm.decode_step(params, cfg, cache=cache, shard=shard, **batch)

    return Cell(arch, shape, serve_step, (params, cache, batch),
                (p_sh, c_sh, b_sh), (logits_sh, c_sh), (1,), {})


def _local_chunk(x, n: int, i: int):
    """Microbatch i of n of a batch DTensor: the i-th of n slices of each
    rank's local rows (no communication; the slices of all ranks together
    are one n-th of the global batch)."""
    if n == 1:
        return x
    loc = x.to_local()
    rows = loc.shape[0] // n
    return R.from_local(loc[i * rows:(i + 1) * rows], x.device_mesh,
                        x.placements, (x.shape[0] // n,) + tuple(x.shape[1:]))


def arg_bytes(cell: Cell) -> int:
    """This rank's bytes of the cell's inputs (their local shards)."""
    def local_bytes(t):
        loc = t.to_local() if hasattr(t, "to_local") else t
        return loc.numel() * loc.element_size()
    return int(sum(local_bytes(t) for t in tree_leaves(list(cell.args))))


def trace_cell(cell: Cell) -> dict:
    """Run the cell's step once on its meta inputs under ``OpTrace``:
    ``optrace``'s record of what this rank runs."""
    from torch.distributed.tensor.experimental import implicit_replication
    tr = optrace.OpTrace()
    tr.inputs(tree_leaves(list(cell.args)))
    with tr, implicit_replication():
        cell.fn(*cell.args)
    return tr.analyze()
