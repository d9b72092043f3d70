"""Shared layers: RMSNorm, embeddings, RoPE and Qwen2-VL's M-RoPE."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.common import ParamSpec


# ---------------- norms ----------------

def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(w, x, eps: float = 1e-5):
    """Normalize in f32, scale by ``w`` in f32, return in ``x``'s dtype:
    the row-invariant kernel on the card, its plain version on the CPU
    (``kernels.ops.rmsnorm``)."""
    return ops.rmsnorm(w, x, eps)


# ---------------- embeddings ----------------

def embed_spec(vocab: int, d: int) -> ParamSpec:
    return ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)


def embed(tok_w, tokens):
    """Rows of the table; a DTensor table (a mesh) is vocab-parallel
    (``_embed_local``)."""
    if ops._dtensor(tok_w):
        return _embed_local(tok_w, tokens)
    return tok_w[tokens]


def _embed_local(tok_w, tokens):
    """Vocab-parallel lookup through ``local_map``: on a mesh dimension
    that splits the vocab (and not the tokens), each rank looks up the
    tokens in its own rows, zeroes the others, and the result is
    ``Partial`` there (summed where it is next redistributed); every
    other split of the table is gathered first, and the tokens keep
    theirs. The table's gradient from each rank's tokens is ``Partial``
    on the mesh dimensions that split the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = tok_w.device_mesh
    tokens = ops._as_dtensor(tokens, mesh)
    t_pl = tuple(p if isinstance(p, Shard) else Replicate()
                 for p in tokens.placements)
    vocab = [i for i, (p, t) in enumerate(zip(tok_w.placements, t_pl))
             if p == Shard(0) and t == Replicate()]
    if len(vocab) > 1:
        raise ValueError("the vocab split over more than one mesh dimension")
    w_pl = tuple(Shard(0) if i in vocab else Replicate()
                 for i in range(mesh.ndim))
    o_pl = tuple(Partial() if i in vocab else t_pl[i]
                 for i in range(mesh.ndim))
    g_pl = tuple(Partial() if t_pl[i] != Replicate() else w_pl[i]
                 for i in range(mesh.ndim))
    V = tok_w.shape[0]

    def local(wl, tl):
        if not vocab:
            return wl[tl]
        i = vocab[0]
        lo = mesh.get_coordinate()[i] * -(-V // mesh.size(i))
        idx = tl - lo
        ok = (idx >= 0) & (idx < wl.shape[0])
        rows = wl[torch.where(ok, idx, torch.zeros_like(idx))]
        return rows * ok[..., None].to(rows.dtype)
    return local_map(local, out_placements=(o_pl,), in_placements=(w_pl, t_pl),
                     in_grad_placements=(g_pl, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(tok_w, tokens)


def head_spec(d: int, vocab: int) -> ParamSpec:
    return ParamSpec((d, vocab), ("embed", "vocab"))


# ---------------- RoPE ----------------

def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, pos, theta: float = 10000.0):
    """x: (..., S, H, hd); pos: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    angles = pos[..., None].float() * freqs              # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_runs(sections, half: int) -> list:
    """(stream, frequencies) runs over the ``half`` = hd / 2 rotary
    frequencies: stream 0 (t), 1 (h), 2 (w) for ``sections`` consecutive
    frequencies each, cut or padded with the last stream to ``half`` (as
    ``jnp.repeat`` with ``total_repeat_length`` does in the JAX package; a
    reduced config's sections may sum past hd / 2). Host ints only: the
    rotation below stays capturable in a CUDA graph."""
    runs, left = [], half
    for i, n in enumerate(sections):
        n = min(n, left)
        if n > 0:
            runs.append((i, n))
        left -= n
    if left > 0:
        runs.append((len(sections) - 1, left))
    return runs


def apply_mrope(x, pos3, sections, theta: float = 10000.0):
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); pos3: (B, S, 3), the
    temporal/height/width position streams. ``sections`` (e.g. (16, 24,
    24)) partitions the hd / 2 rotary frequencies, each partition rotated
    by its own position stream. With t = h = w it is ``apply_rope``."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)       # (hd/2,)
    p = pos3.float()
    pos_per_freq = torch.cat(
        [p[..., i:i + 1].expand(*p.shape[:-1], n)
         for i, n in mrope_runs(sections, hd // 2)], dim=-1)  # (B, S, hd/2)
    angles = (pos_per_freq * freqs)[..., None, :]        # (B, S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
