"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory, exponential
gating), the port of the JAX package's ``models/xlstm.py``.

Both run their exact recurrent form, one step a position, in f32: the same
code serves a prefill (the whole prompt, from ``*_init_state``) and a decode
step (S = 1 from the carried state). States are stabilized in log space
(``m``). With ``seq_lens`` every state leaf is carried unchanged through a
row's right pads, so the returned state is the one at the row's true
length. The time loop runs in chunks (``_chunked_scan``), each checkpointed
where autograd records, as the JAX package's ``_chunked_scan``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import NO_SHARD, ParamSpec
from repro_torch.models.scan import scan_chunks

# steps a checkpointed chunk of the time scan at most (the JAX package's 64)
SCAN_CHUNK = 64

def _di(cfg) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


def _log_sigmoid(x):
    return -F.softplus(-x)


def _ok(seq_lens, S, device):
    """(B, S) step validity of right-padded rows, or None."""
    if seq_lens is None:
        return None
    return torch.arange(S, device=device)[None, :] < seq_lens[:, None]


def _chunked_scan(step, state, xs, S: int, chunk: int = 64, consts=()):
    """``step(state, xs_t, *consts) -> (state, y_t)`` over the S steps of
    ``xs`` (a tuple of (B, S, ...) tensors or None), in chunks of ``c``
    steps, c the largest divisor of S up to ``chunk`` (the JAX package's
    rule). Each chunk is checkpointed where autograd records
    (``scan.scan_chunks``): the backward keeps the chunk-boundary states,
    not one (B, H, hd, hd) matrix memory a step. Returns (state, ys (B, S,
    ...))."""
    c = min(S, chunk)
    while S % c:
        c -= 1

    def run(st, xc, *cs):
        cols = [None if a is None else a.unbind(1) for a in xc]
        ys = []
        for t in range(c):
            st, y = step(st, tuple(None if col is None else col[t]
                                   for col in cols), *cs)
            ys.append(y)
        return st, torch.stack(ys, dim=1)
    return scan_chunks(run, state, xs, S // c, consts)


def _merge_heads(hs, di: int):
    """(B, S, h, hd) -> (B, S, di). On a mesh the result is redistributed
    at once (a Partial placement to a split of di where the mesh dimension
    divides di, else to Replicate). The redistribute's backward turns the
    incoming gradient into the view's own placements, Replicate over di,
    before the view's backward unflattens it into heads: DTensor refuses
    that unflatten on a split the head count does not divide (4 heads over
    16), as in xlstm-125m's train cells."""
    y = hs.reshape(*hs.shape[:2], di)
    if type(y) is torch.Tensor or not hasattr(y, "placements"):
        return y
    from torch.distributed.tensor import Replicate, Shard
    mesh = y.device_mesh
    pl = tuple((Shard(2) if di % mesh.size(i) == 0 else Replicate())
               if p.is_partial() else p for i, p in enumerate(y.placements))
    return y.redistribute(mesh, pl)


def _carry(new: dict, old: dict, okt):
    """Each leaf of ``new`` where the row's step is valid, else ``old``'s."""
    if okt is None:
        return new
    return {k: torch.where(okt.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                           old[k]) for k, v in new.items()}


# ---------------- mLSTM ----------------

def mlstm_spec(cfg) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    di = _di(cfg)
    hd = di // h
    return {
        "up": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "wq": ParamSpec((di, h, hd), ("mlp", "heads", None)),
        "wk": ParamSpec((di, h, hd), ("mlp", "heads", None)),
        "wv": ParamSpec((di, h, hd), ("mlp", "heads", None)),
        "wif": ParamSpec((di, 2 * h), ("mlp", None), scale=0.1),
        "b_if": ParamSpec((2 * h,), (None,), init="zeros"),
        "down": ParamSpec((di, d), ("mlp", "embed")),
    }


def mlstm_init_state(cfg, batch: int, device="cuda") -> dict:
    h = cfg.num_heads
    hd = _di(cfg) // h
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, hd, hd), **f32),
            "n": torch.zeros((batch, h, hd), **f32),
            "m": torch.full((batch, h), -1e30, **f32)}


def _heads(x, w):
    """x: (B, S, di) @ w: (di, h, hd) -> (B, S, h, hd) f32."""
    di, h, hd = w.shape
    return (x @ w.to(x.dtype).reshape(di, h * hd)).float().reshape(
        *x.shape[:2], h, hd)


def mlstm_forward(p, x, cfg, state=None, seq_lens=None, shard=NO_SHARD):
    """x: (B, S, d) -> (y, state'). ``state`` None starts from
    ``mlstm_init_state`` (a prefill); a decode step passes the cache."""
    B, S, d = x.shape
    h = cfg.num_heads
    di = _di(cfg)
    hd = di // h
    dt = x.dtype
    xin, z = (x @ p["up"].to(dt)).chunk(2, dim=-1)
    xin = shard(xin, ("batch", None, "mlp"))
    scale = 1.0 / math.sqrt(hd)
    # q, k, v and the gates whole over the model split (4 heads do not
    # split 16 ways): left Partial sums, DTensor's strategies reduce-
    # scattered them over the sequence or the head dim, and the backward's
    # products and head views then flattened a split dim, which torch
    # 2.11's DTensor refuses (xlstm-125m's train cells)
    whole = ("batch", None, None, None)
    q = shard(_heads(xin, p["wq"]), whole)
    k = shard(_heads(xin, p["wk"]) * scale, whole)
    v = shard(_heads(xin, p["wv"]), whole)
    ifl = shard((xin @ p["wif"].to(dt)).float() + p["b_if"].float(),
                whole[:3])
    i_log, f_raw = ifl.chunk(2, dim=-1)                    # (B, S, H)
    f_log = _log_sigmoid(f_raw)
    st = state if state is not None else mlstm_init_state(cfg, B, x.device)

    def step(st, xt):
        qt, kt, vt, il, fl, okt = xt
        fm = fl + st["m"]
        m_new = torch.maximum(fm, il)
        i_g = torch.exp(il - m_new)[..., None]             # (B, H, 1)
        f_g = torch.exp(fm - m_new)[..., None]
        C = f_g[..., None] * st["C"] + i_g[..., None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_g * st["n"] + i_g * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.maximum((n * qt).sum(-1).abs(), torch.exp(-m_new))
        return _carry({"C": C, "n": n, "m": m_new}, st, okt), \
            num / den[..., None]

    st, hs = _chunked_scan(step, st, (q, k, v, i_log, f_log,
                                      _ok(seq_lens, S, x.device)), S,
                           SCAN_CHUNK)
    y = _merge_heads(hs, di).to(dt) * F.silu(z)
    return y @ p["down"].to(dt), st


# ---------------- sLSTM ----------------

def slstm_spec(cfg) -> dict:
    d = cfg.d_model
    di = _di(cfg)
    return {
        "up": ParamSpec((d, di), ("embed", "mlp")),
        "w": ParamSpec((di, 4 * di), ("mlp", None), scale=0.05),
        "r": ParamSpec((di, 4 * di), ("mlp", None), scale=0.05),
        "b": ParamSpec((4 * di,), (None,), init="zeros"),
        "down": ParamSpec((di, d), ("mlp", "embed")),
    }


def slstm_init_state(cfg, batch: int, device="cuda") -> dict:
    di = _di(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **f32),
            "n": torch.zeros((batch, di), **f32),
            "h": torch.zeros((batch, di), **f32),
            "m": torch.full((batch, di), -1e30, **f32)}


def slstm_forward(p, x, cfg, state=None, seq_lens=None, shard=NO_SHARD):
    """x: (B, S, d) -> (y, state'). Sequential in the recurrent ``h``; the
    recurrent ``r`` and bias ``b`` are used in f32."""
    B, S, d = x.shape
    dt = x.dtype
    xin = shard(x @ p["up"].to(dt), ("batch", None, "mlp"))
    wx = (xin @ p["w"].to(dt)).float() + p["b"].float()
    r = p["r"].float()
    st = state if state is not None else slstm_init_state(cfg, B, x.device)

    def step(st, xt, r):
        wxt, okt = xt
        gates = wxt + st["h"] @ r                          # (B, 4 di)
        zi, ii, fi, oi = gates.chunk(4, dim=-1)
        zt = torch.tanh(zi)
        ot = torch.sigmoid(oi)
        f_log = _log_sigmoid(fi)
        fm = f_log + st["m"]
        m_new = torch.maximum(fm, ii)
        i_g = torch.exp(ii - m_new)
        f_g = torch.exp(fm - m_new)
        c = f_g * st["c"] + i_g * zt
        n = torch.clamp(f_g * st["n"] + i_g, min=1e-6)
        h = ot * c / n
        return _carry({"c": c, "n": n, "h": h, "m": m_new}, st, okt), h

    st, hs = _chunked_scan(step, st, (wx, _ok(seq_lens, S, x.device)), S,
                           SCAN_CHUNK, consts=(r,))
    y = hs.to(dt)
    return y @ p["down"].to(dt), st
