"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory, exponential
gating), the port of the JAX package's ``models/xlstm.py``.

Both run their exact recurrent form, one step a position, in f32: the same
code serves a prefill (the whole prompt, from ``*_init_state``) and a decode
step (S = 1 from the carried state). States are stabilized in log space
(``m``). With ``seq_lens`` every state leaf is carried unchanged through a
row's right pads, so the returned state is the one at the row's true
length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import NO_SHARD, ParamSpec


def _di(cfg) -> int:
    return int(cfg.xlstm_proj_factor * cfg.d_model)


def _log_sigmoid(x):
    return -F.softplus(-x)


def _ok(seq_lens, S, device):
    """(S, B) step validity of right-padded rows, or None."""
    if seq_lens is None:
        return None
    return torch.arange(S, device=device)[:, None] < seq_lens[None, :]


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
    q = _heads(xin, p["wq"])
    k = _heads(xin, p["wk"]) * scale
    v = _heads(xin, p["wv"])
    ifl = (xin @ p["wif"].to(dt)).float() + p["b_if"].float()
    i_log, f_raw = ifl.chunk(2, dim=-1)                    # (B, S, H)
    f_log = _log_sigmoid(f_raw)
    st = state if state is not None else mlstm_init_state(cfg, B, x.device)
    ok = _ok(seq_lens, S, x.device)
    hs = []
    for t in range(S):
        qt, kt, vt, il, fl = q[:, t], k[:, t], v[:, t], i_log[:, t], \
            f_log[:, t]
        m_new = torch.maximum(fl + st["m"], il)
        i_g = torch.exp(il - m_new)[..., None]             # (B, H, 1)
        f_g = torch.exp(fl + st["m"] - m_new)[..., None]
        C = f_g[..., None] * st["C"] + i_g[..., None] * (
            vt[..., :, None] * kt[..., None, :])
        n = f_g * st["n"] + i_g * kt
        num = (C @ qt[..., None])[..., 0]
        den = torch.maximum((n * qt).sum(-1).abs(), torch.exp(-m_new))
        st = _carry({"C": C, "n": n, "m": m_new}, st,
                    None if ok is None else ok[t])
        hs.append(num / den[..., None])
    y = torch.stack(hs, dim=1).reshape(B, S, di).to(dt) * F.silu(z)
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
    ok = _ok(seq_lens, S, x.device)
    hs = []
    for t in range(S):
        gates = wx[:, t] + st["h"] @ r                     # (B, 4 di)
        zi, ii, fi, oi = gates.chunk(4, dim=-1)
        zt = torch.tanh(zi)
        ot = torch.sigmoid(oi)
        f_log = _log_sigmoid(fi)
        m_new = torch.maximum(f_log + st["m"], ii)
        i_g = torch.exp(ii - m_new)
        f_g = torch.exp(f_log + st["m"] - m_new)
        c = f_g * st["c"] + i_g * zt
        n = torch.clamp(f_g * st["n"] + i_g, min=1e-6)
        h = ot * c / n
        st = _carry({"c": c, "n": n, "h": h, "m": m_new}, st,
                    None if ok is None else ok[t])
        hs.append(h)
    y = torch.stack(hs, dim=1).to(dt)
    return y @ p["down"].to(dt), st
