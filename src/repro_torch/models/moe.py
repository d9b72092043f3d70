"""Top-k Mixture-of-Experts FFN (the port of the JAX package's
``models/moe.py``).

Two dispatch strategies (``dispatch=``), sharing one router and one
capacity rule:

* ``"gshard"``: capacity-based one-hot dispatch and combine (GShard/Switch)
  over sequence subgroups; every expert's matrices are read whatever the
  routing (a decode step touches all of them);
* ``"scatter"``: the same slots filled and read back by index.

``"ep"`` (expert parallelism) needs a device mesh; without one it falls
back to gshard, as the JAX package does when its mesh does not fit.

Routing is per row (the JAX package vmaps over the batch): a row's capacity
cumsum, drops and output depend on that row alone, so a free or padded row
never moves a live row's routing. The router computes in f32 from an f32
weight; the expert matrices compute in the activations' dtype. ``moe_ref``
is a per-token oracle without capacity drops, for tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import ParamSpec


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
    ce = torch.zeros(*flat.shape[:-1], e, dtype=torch.float32,
                     device=xg.device).scatter_add_(
        -1, flat, torch.ones(flat.shape, dtype=torch.float32,
                             device=xg.device)) / flat.shape[-1]
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


def _expert_ffn(p, x_e):
    """x_e: (B, E, C, d) -> (B, E, C, d): each expert's gated FFN over its
    C slots of every row, one batched product per matrix over E."""
    B, E, C, d = x_e.shape
    dt = x_e.dtype
    xt = x_e.transpose(0, 1).reshape(E, B * C, d)
    g = torch.bmm(xt, p["wi_gate"].to(dt))
    u = torch.bmm(xt, p["wi_up"].to(dt))
    out = torch.bmm(F.silu(g) * u, p["wo"].to(dt))
    return out.reshape(E, B, C, d).transpose(0, 1)


def _group_gshard(p, xg, k, cap, valid=None):
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
    y_e = _expert_ffn(p, x_e).reshape(B, e * cap, d)
    return combine @ y_e, aux.mean()


def _group_scatter(p, xg, k, cap, valid=None):
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
    y_e = _expert_ffn(p, x_e[:, :-1].reshape(B, e, cap, d))
    y_tok = y_e.reshape(B, e * cap, d)[rows, torch.clamp(slot,
                                                         max=e * cap - 1)]
    y_tok = y_tok.reshape(B, g, k, d) * (keep * gate_k).to(dt)[..., None]
    return y_tok.sum(dim=2), aux.mean()


def moe_ffn(p, x, *, k: int, dispatch: str = "gshard", subgroup: int = 1024,
            valid=None):
    """x: (B, S, d) -> ((B, S, d), aux loss). The sequence is cut into
    subgroups of ``gc = min(S, subgroup)`` positions (decremented until it
    divides S), each routed with capacity ``capacity(gc, k, E)``: a decode
    step (S 1) gets ``cap == k`` and drops nothing.

    ``valid`` (B, S) bool: right-padded variable-length prefill: pad
    positions claim no expert capacity and get a zero output, so a real
    token's routing does not depend on its admission bucket's padding."""
    if dispatch == "ep":
        dispatch = "gshard"        # no device mesh: the JAX fallback
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
                      valid=None if valid is None else valid[:, i:i + gc])
        outs.append(out)
        auxs.append(aux)
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out, torch.stack(auxs).mean()


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
