"""Mamba (selective SSM) block of Jamba's hybrid stack (the port of the JAX
package's ``models/mamba.py``).

The recurrence ``h = h * dA_t + dBx_t`` runs sequentially in f32, one step
a position, in chunks of at most ``chunk`` positions so that the per-step
(di, d_state) updates of a chunk are materialized together. It is a loop of
small tensor ops: a serving engine captures each prefill bucket's loop in
that key's CUDA graph. Where autograd records each chunk is checkpointed
(``scan.scan_chunks``), as the JAX package's ``jax.checkpoint`` per chunk:
the backward keeps the chunk-boundary states and recomputes one chunk's
``dA``/``dBx``/states at a time.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import NO_SHARD, ParamSpec
from repro_torch.models.scan import scan_chunks


def mamba_spec(cfg) -> dict:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    return {
        "in_proj": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "conv_w": ParamSpec((dc, di), (None, "mlp"), scale=0.5),
        "conv_b": ParamSpec((di,), ("mlp",), init="zeros"),
        "x_bc": ParamSpec((di, 2 * ds), ("mlp", None)),
        "x_dt": ParamSpec((di, 1), ("mlp", None)),
        "dt_bias": ParamSpec((di,), ("mlp",), init="zeros"),
        "A_log": ParamSpec((di, ds), ("mlp", None), init="zeros"),
        "D": ParamSpec((di,), ("mlp",), init="ones"),
        "out_proj": ParamSpec((di, d), ("mlp", "embed")),
    }


def _ssm_chunk(x, dt, B, C, A, D, h0):
    """Sequential scan over one chunk of every row. x/dt: (Bsz, T, di);
    B/C: (Bsz, T, ds); h0: (Bsz, di, ds). Returns (y (Bsz, T, di), hT)."""
    dA = torch.exp(dt[..., None] * A)                     # (Bsz, T, di, ds)
    dBx = dt[..., None] * B[:, :, None, :] * x[..., None]
    hs = []
    h = h0
    for t in range(x.shape[1]):
        h = h * dA[:, t] + dBx[:, t]
        hs.append(h)
    # stacked, not written into a buffer in place: on a mesh the in-place
    # write's backward asked DTensor for a Shard -> Partial redistribute
    hs = torch.stack(hs, dim=1)
    y = (hs @ C[..., None])[..., 0] + x * D
    return y, h


def mamba_forward(p, x, cfg, conv_state=None, ssm_state=None,
                  chunk: int = 128, seq_lens=None, shard=NO_SHARD):
    """x: (B, S, d). Returns (y, (conv_state, ssm_state)), the states being
    the decode cache; a prefill passes no state (zeros).

    ``seq_lens`` (B,) makes the scan variable-length for right-padded rows:
    ``dt`` is zeroed at pad positions, so ``dA = exp(0 * A) = 1`` and
    ``dBx = 0`` and the SSM update is an exact identity through the
    padding, and the returned conv state is gathered per row at its true
    length. Pad outputs are garbage (the caller discards them); valid
    positions equal an unpadded run's, the conv window and the recurrence
    being causal."""
    Bsz, S, d = x.shape
    di = cfg.mamba_expand * d
    ds = cfg.mamba_d_state
    dc = cfg.mamba_d_conv
    dt_x = x.dtype
    xin, z = (x @ p["in_proj"].to(dt_x)).chunk(2, dim=-1)    # (B, S, di) each
    xin = shard(xin, ("batch", None, "mlp"))
    # causal depthwise conv of width dc
    if conv_state is None:
        conv_state = torch.zeros((Bsz, dc - 1, di), dtype=dt_x,
                                 device=x.device)
    xpad = torch.cat([conv_state.to(dt_x), xin], dim=1)    # (B, S+dc-1, di)
    if dc <= 1:
        new_conv = conv_state
    elif seq_lens is None:
        new_conv = xpad[:, -(dc - 1):]
    else:
        # the dc - 1 inputs before each row's true end: xpad[b, L_b:L_b+dc-1]
        idx = seq_lens.long()[:, None] + torch.arange(dc - 1,
                                                      device=x.device)
        new_conv = torch.gather(xpad, 1, idx[..., None].expand(-1, -1, di))
    w = p["conv_w"].to(dt_x)
    xc = xpad[:, 0:S] * w[0]
    for i in range(1, dc):
        xc = xc + xpad[:, i:i + S] * w[i]
    xc = F.silu(xc + p["conv_b"].to(dt_x))
    # the di-contracted products whole over the model split: left Partial
    # sums, DTensor reduce-scattered them over the sequence, which the
    # scan's (B, T) products then flattened (torch 2.11 refuses)
    whole = ("batch", None, None)
    Bm, Cm = shard((xc @ p["x_bc"].to(dt_x)).float(), whole).chunk(
        2, dim=-1)                                          # (B, S, ds)
    dt = F.softplus(shard((xc @ p["x_dt"].to(dt_x)).float(), whole)
                    + p["dt_bias"].float())                 # (B, S, di)
    if seq_lens is not None:
        valid = torch.arange(S, device=x.device)[None] < seq_lens[:, None]
        dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"].float())                      # (di, ds)
    D = p["D"].float()
    h = ssm_state if ssm_state is not None else torch.zeros(
        (Bsz, di, ds), dtype=torch.float32, device=x.device)
    c = min(S, chunk)
    while S % c:
        c -= 1

    def run(h, xs, A, D):
        y, h = _ssm_chunk(*xs, A, D, h)
        return h, y
    h, y = scan_chunks(run, h, (xc.float(), dt, Bm, Cm), S // c, (A, D))
    y = y.to(dt_x) * F.silu(z)
    return y @ p["out_proj"].to(dt_x), (new_conv, h)


def mamba_decode(p, x, cfg, conv_state, ssm_state, shard=NO_SHARD):
    """One-step decode. x: (B, 1, d); conv_state: (B, dc-1, di); ssm_state:
    (B, di, ds)."""
    return mamba_forward(p, x, cfg, conv_state=conv_state,
                         ssm_state=ssm_state, chunk=1, shard=shard)
