"""Top-k Mixture-of-Experts FFN (the port of the JAX package's
``models/moe.py``).

Two dispatch strategies (``dispatch=``), sharing one router and one
capacity rule:

* ``"gshard"``: capacity-based one-hot dispatch and combine (GShard/Switch)
  over sequence subgroups; every expert's matrices are read whatever the
  routing (a decode step touches all of them);
* ``"scatter"``: the same slots filled and read back by index;
* ``"ep"``: expert parallelism on a mesh (``_moe_ep``, a ``local_map``
  over the "model" dimension). Where there is no mesh, or the mesh or the
  expert count does not fit, it falls back to gshard, as the JAX package
  does.

Routing is per row (the JAX package vmaps over the batch): a row's capacity
cumsum, drops and output depend on that row alone, so a free or padded row
never moves a live row's routing. The router computes in f32 from an f32
weight; the expert matrices compute in the activations' dtype. ``moe_ref``
is a per-token oracle without capacity drops, for tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import NO_SHARD, ParamSpec


def moe_spec(cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": ParamSpec((d, e), ("embed", "experts_v")),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "mlp", "embed")),
    }


def capacity(group: int, k: int, num_experts: int, factor: float = 1.25) -> int:
    c = int(group * k / num_experts * factor)
    c = max(c, k)
    return (c + 7) // 8 * 8 if c > 8 else c


def one_hot(idx, n: int, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row. A
    comparison, so it never reads an index back to the host (capturable in
    a CUDA graph)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top_k(probs, k: int):
    """The k largest along the last axis, the lower index first on a tie
    (``jax.lax.top_k``'s order): a stable descending sort, sliced."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, xg, k):
    """xg: (..., g, d) -> gates (..., g, k) f32, expert ids (..., g, k) and
    the Switch load-balance loss (...,) of each group."""
    logits = xg.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_k, idx_k = top_k(probs, k)
    gate_k = gate_k / torch.clamp(gate_k.sum(-1, keepdim=True), min=1e-9)
    e = probs.shape[-1]
    me = probs.mean(dim=-2)
    flat = idx_k.reshape(*idx_k.shape[:-2], -1)
    if type(flat) is torch.Tensor:
        ce = torch.zeros(*flat.shape[:-1], e, dtype=torch.float32,
                         device=xg.device).scatter_add_(
            -1, flat, torch.ones(flat.shape, dtype=torch.float32,
                                 device=xg.device)) / flat.shape[-1]
    else:   # a DTensor (a mesh): the same integer counts, out of place
        ce = one_hot(flat, e, torch.float32).sum(-2) / flat.shape[-1]
    return gate_k, idx_k, e * (me * ce).sum(-1)


def _positions(idx_k, num_experts: int, cap: int, valid=None):
    """Slot assignment: (..., g, k) expert ids -> (pos_in_expert, keep),
    each (..., g, k). First choices claim slots before second choices
    (k-major order), as in GShard. ``valid`` (..., g) bool: tokens marked
    invalid (right pads of a variable-length prefill) take no part in the
    capacity cumsum and are always dropped."""
    g, k = idx_k.shape[-2:]
    mask = one_hot(idx_k, num_experts, torch.int32)             # (..., g, k, E)
    if valid is not None:
        mask = mask * valid[..., None, None].to(torch.int32)
    mk = mask.transpose(-3, -2)                                  # (..., k, g, E)
    mflat = mk.reshape(*mk.shape[:-3], k * g, num_experts)       # k-major
    pos_flat = torch.cumsum(mflat, dim=-2) - mflat
    pos = (pos_flat.reshape(mk.shape) * mk).sum(-1).transpose(-2, -1)
    keep = pos < cap
    if valid is not None:
        keep = keep & valid[..., None]
    return pos, keep


def _expert_ffn(p, x_e, shard=NO_SHARD):
    """x_e: (B, E, C, d) -> (B, E, C, d): each expert's gated FFN over its
    C slots of every row, one batched product per matrix over E, the
    experts sharded over "model" on a mesh."""
    B, E, C, d = x_e.shape
    dt = x_e.dtype
    xt = shard(x_e.transpose(0, 1).reshape(E, B * C, d),
               ("experts", None, None))
    g = torch.bmm(xt, p["wi_gate"].to(dt))
    u = torch.bmm(xt, p["wi_up"].to(dt))
    h = shard(F.silu(g) * u, ("experts", None, "mlp"))
    out = shard(torch.bmm(h, p["wo"].to(dt)), ("experts", None, None))
    return out.reshape(E, B, C, d).transpose(0, 1)


def _group_gshard(p, xg, k, cap, valid=None, shard=NO_SHARD):
    """One subgroup, one-hot dispatch. xg: (B, g, d) -> (B, g, d), aux."""
    B, g, d = xg.shape
    gate_k, idx_k, aux = _router(p, xg, k)
    e = p["router"].shape[-1]
    dt = xg.dtype
    pos, keep = _positions(idx_k, e, cap, valid=valid)
    # (B, g, k, E, C); a dropped token's row is zero
    oh = (one_hot(idx_k, e, dt)[..., None] * one_hot(pos, cap, dt)[..., None, :]
          * keep[..., None, None].to(dt))
    dispatch = oh.sum(dim=2).reshape(B, g, e * cap)
    combine = (oh * gate_k[..., None, None].to(dt)).sum(dim=2).reshape(
        B, g, e * cap)
    x_e = (dispatch.transpose(1, 2) @ xg).reshape(B, e, cap, d)
    y_e = _expert_ffn(p, x_e, shard).reshape(B, e * cap, d)
    return combine @ y_e, aux.mean()


def _group_scatter(p, xg, k, cap, valid=None, shard=NO_SHARD):
    """One subgroup, scatter/gather dispatch. xg: (B, g, d) -> (B, g, d),
    aux. Slot ``e * cap`` is the overflow row every dropped token writes."""
    B, g, d = xg.shape
    gate_k, idx_k, aux = _router(p, xg, k)
    e = p["router"].shape[-1]
    dt = xg.dtype
    pos, keep = _positions(idx_k, e, cap, valid=valid)
    slot = torch.where(keep, idx_k * cap + pos,
                       torch.full_like(idx_k, e * cap)).reshape(B, g * k)
    rows = torch.arange(B, device=xg.device)[:, None]
    tok = torch.arange(g, device=xg.device).repeat_interleave(k)
    x_e = torch.zeros((B, e * cap + 1, d), dtype=dt, device=xg.device)
    x_e[rows, slot] = xg[:, tok]
    y_e = _expert_ffn(p, x_e[:, :-1].reshape(B, e, cap, d), shard)
    y_tok = y_e.reshape(B, e * cap, d)[rows, torch.clamp(slot,
                                                         max=e * cap - 1)]
    y_tok = y_tok.reshape(B, g, k, d) * (keep * gate_k).to(dt)[..., None]
    return y_tok.sum(dim=2), aux.mean()


def moe_ffn(p, x, *, k: int, dispatch: str = "gshard", subgroup: int = 1024,
            valid=None, shard=NO_SHARD):
    """x: (B, S, d) -> ((B, S, d), aux loss). The sequence is cut into
    subgroups of ``gc = min(S, subgroup)`` positions (decremented until it
    divides S), each routed with capacity ``capacity(gc, k, E)``: a decode
    step (S 1) gets ``cap == k`` and drops nothing.

    ``valid`` (B, S) bool: right-padded variable-length prefill: pad
    positions claim no expert capacity and get a zero output, so a real
    token's routing does not depend on its admission bucket's padding.

    ``dispatch="ep"`` on a mesh (``shard.mesh``) runs ``_moe_ep``; where it
    returns None (no mesh, or the mesh or the expert count does not fit)
    gshard runs instead, as in the JAX package."""
    if dispatch == "ep":
        out = _moe_ep(p, x, k, shard, valid)
        if out is not None:
            return out
        dispatch = "gshard"        # mesh/divisibility fallback
    if dispatch not in ("gshard", "scatter"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    B, S, d = x.shape
    gc = min(S, subgroup)
    while S % gc:
        gc -= 1
    e = p["router"].shape[-1]
    cap = capacity(gc, k, e)
    fn = _group_gshard if dispatch == "gshard" else _group_scatter
    outs, auxs = [], []
    for i in range(0, S, gc):
        out, aux = fn(p, x[:, i:i + gc], k, cap,
                      valid=None if valid is None else valid[:, i:i + gc],
                      shard=shard)
        outs.append(out)
        auxs.append(aux)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out, torch.stack(auxs).mean()


def _moe_ep(p, x, k: int, shard, valid=None):
    """Expert parallelism, a ``local_map`` over the mesh (the JAX
    package's ``shard_map`` one).

    Tokens stay split over the batch dimensions and replicated over
    "model"; each model rank routes ALL its local tokens (one group of
    ``t_loc`` tokens, capacity ``capacity(t_loc, k, e)``, the same
    ``_positions`` drops as gshard) but dispatches, by a local scatter,
    only to the experts it owns (rank m: experts [m e_loc, (m+1) e_loc)),
    runs their FFNs, combines locally, and one bf16 all-reduce over
    "model" assembles the output. ``aux`` is averaged over the batch
    dimensions. Returns None where there is no mesh, the mesh has no
    "model" dimension, the experts do not divide over it, or the batch
    does not divide over the batch dimensions (the caller falls back to
    gshard)."""
    mesh = getattr(shard, "mesh", None)
    if mesh is None or "model" not in (mesh.mesh_dim_names or ()):
        return None
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.ops import _as_dtensor
    names = list(mesh.mesh_dim_names)
    mi = names.index("model")
    M = mesh.size(mi)
    e = p["router"].shape[-1]
    if e % M != 0:
        return None
    batch_dims = [names.index(a) for a in ("pod", "data") if a in names]
    B, S, d = x.shape
    dp = 1
    for i in batch_dims:
        dp *= mesh.size(i)
    if B % dp != 0:
        return None
    e_loc = e // M
    t_loc = (B // dp) * S
    cap = capacity(t_loc, k, e)

    def pl(batch, model):
        return tuple(batch if i in batch_dims else
                     model if i == mi else Replicate()
                     for i in range(mesh.ndim))
    rep = pl(Replicate(), Replicate())
    xpl = pl(Shard(0), Replicate())
    wpl = pl(Replicate(), Shard(0))

    def local_fn(xl, vl, router_w, wg, wu, wo):
        b_loc, s, _ = xl.shape
        T = b_loc * s
        dt = xl.dtype
        xf = xl.reshape(T, d)
        gate_k, idx_k, aux = _router({"router": router_w}, xf, k)
        pos, keep = _positions(idx_k, e, cap,
                               valid=None if vl is None else vl.reshape(T))
        m_idx = mesh.get_coordinate()[mi]
        keep_loc = keep & ((idx_k // e_loc) == m_idx)
        slot = torch.where(keep_loc, (idx_k % e_loc) * cap + pos,
                           torch.full_like(idx_k, e_loc * cap))
        tok = torch.arange(T, device=xl.device).repeat_interleave(k)
        x_e = torch.zeros((e_loc * cap + 1, d), dtype=dt, device=xl.device)
        x_e[slot.reshape(-1)] = xf[tok]
        x_e = x_e[:-1].reshape(e_loc, cap, d)
        g = torch.bmm(x_e, wg.to(dt))
        u = torch.bmm(x_e, wu.to(dt))
        y_e = torch.bmm(F.silu(g) * u, wo.to(dt))
        y_tok = y_e.reshape(e_loc * cap, d)[
            torch.clamp(slot, max=e_loc * cap - 1).reshape(-1)]
        y = (y_tok.reshape(T, k, d)
             * (keep_loc * gate_k).to(dt)[..., None]).sum(dim=1)
        # aux is the same on every model rank: each carries 1/M of it,
        # so its sum over "model" (and its gradient) counts it once
        return y.reshape(b_loc, s, d), aux / M

    out_pl = pl(Shard(0), Partial())
    aux_pl = pl(Partial("avg"), Partial())
    args = tuple(_as_dtensor(t, mesh) for t in (
        x, valid, p["router"], p["wi_gate"], p["wi_up"], p["wo"]))
    in_pl = (xpl, None if valid is None else xpl, rep, wpl, wpl, wpl)
    grad_pl = (pl(Shard(0), Partial()), in_pl[1],
               pl(Partial(), Partial()), pl(Partial(), Shard(0)),
               pl(Partial(), Shard(0)), pl(Partial(), Shard(0)))
    out, aux = local_map(local_fn, out_placements=(out_pl, aux_pl),
                         in_placements=in_pl, in_grad_placements=grad_pl,
                         device_mesh=mesh, redistribute_inputs=True)(*args)
    out = out.redistribute(mesh, xpl)             # the one all-reduce
    return out, aux.redistribute(mesh, rep).mean()


def moe_ref(p, x, k: int):
    """Per-token oracle without capacity drops (tests only)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    gate_k, idx_k, _ = _router(p, xf, k)
    outs = []
    for t in range(xf.shape[0]):
        acc = torch.zeros((d,), dtype=torch.float32, device=x.device)
        for j in range(k):
            e = int(idx_k[t, j])
            h = F.silu(xf[t] @ p["wi_gate"][e]) * (xf[t] @ p["wi_up"][e])
            acc = acc + gate_k[t, j] * (h @ p["wo"][e]).float()
        outs.append(acc)
    return torch.stack(outs).reshape(B, S, d).to(x.dtype)
