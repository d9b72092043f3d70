"""Decode against a cache split over its sequence (the long-context rules,
``cache_seq`` over "data"): K5's and K3's plain versions with a key offset
and a log-sum-exp, ``models.attention.merge_partials``, ``lm.decode_step``
on gloo ranks each holding one piece of a float or an int8 cache, and the
dry-run's long_500k cells.

Ranks are spawned (``torch.multiprocessing``) and meet over a
``FileStore`` under a temporary directory; their functions live here and
import no jax. The JAX side runs in this process on the whole cache.

Tolerances:
  K5's pieces merged against the JAX package's jnp ``decode_attention`` on
      the whole cache: two bf16 ulps of the largest output (chip_smoke's
      bar for K5: the JAX function rounds the probabilities normalised over
      the whole cache to bf16, each piece rounds its own); the merged
      log-sum-exp within 1e-5 of numpy's over the valid scores; a piece
      without a valid key exactly o = 0 and lse = -inf;
  the split decode against the port without a mesh: the logits within
      1e-2 rel L2 and 5e-2 absolute, the caches' K/V within 1e-2 rel L2
      and two bf16 ulps of their largest value (the merge rounds the
      pieces' f32 outputs once to bf16 where one call rounds once as well,
      but its sums run in another order, and each layer's new K/V sees
      the attention below it), the lengths exactly, and the positions past
      the row's length exactly zero (no piece wrote there);
  against the JAX package's unsplit ``decode_step``, teacher-forced:
      ``tests/test_torch_families.py``'s LOGIT_TOL, (4e-2, 0.25);
  K3's pieces merged against the JAX package's ``decode_attention_int8``
      (its Pallas kernel in interpret mode, as ``tests/test_kernels.py``
      runs it) on the whole cache: 1e-5 of the largest output (both sides
      dequantize the same codes and run in f32 without rounding p; only
      the order of the sums differs), the log-sum-exp within 1e-5 of
      numpy's;
  the int8 split decode: the bars of the float one, and the int8 codes of
      the new tokens within one code of the mesh-less cache's (a code
      rounds the new K/V, which later layers compute from the merged
      attention's rounding); every rank's piece changed only at the
      positions it holds among those written, nothing past a row's length.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_TOL = (4e-2, 0.25)
MESH_TOL = (1e-2, 5e-2)
B, H, KV, HD = 3, 8, 2, 16

# K5 cases: a window whose range straddles pieces (the first piece wholly
# before it), pieces past every row's length, lengths of 1 (one valid key,
# in piece 0), a window of 1
K5_CASES = {
    "window_straddles_pieces": dict(S=64, pieces=4, lens=[40, 23, 64],
                                    window=20),
    "pieces_past_the_length": dict(S=64, pieces=4, lens=[16, 9, 48]),
    "len_1": dict(S=64, pieces=4, lens=[1, 1, 1]),
    "window_of_1": dict(S=64, pieces=2, lens=[1, 33, 64], window=1),
}


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    rel, worst = rel_l2(got, want), float(np.abs(got - want).max())
    assert rel <= tol[0] and worst <= tol[1], (rel, worst)


def _k5_inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, HD).astype(np.float32)
    k = rng.randn(B, case["S"], KV, HD).astype(np.float32)
    v = rng.randn(B, case["S"], KV, HD).astype(np.float32)
    return q, k, v, np.asarray(case["lens"], np.int32)


@pytest.mark.parametrize("name", sorted(K5_CASES))
def test_k5_pieces_merge_to_jax_decode_attention(name):
    """The cache cut into pieces, each through ``ops.decode_attention``'s
    plain version with its key offset and ``return_lse``, merged by
    ``merge_partials``: the JAX package's decode attention on the whole
    cache; empty pieces weigh nothing; one piece at offset 0 rounds to the
    bits of a call without the log-sum-exp."""
    import jax.numpy as jnp
    from repro.models.attention import decode_attention as jdecode
    case = K5_CASES[name]
    window = case.get("window")
    q, k, v, lens = _k5_inputs(case)
    bf = torch.bfloat16
    tq, tk, tv = (torch.tensor(a).to(bf) for a in (q, k, v))
    tl = torch.tensor(lens)
    want = np.asarray(jdecode(jnp.asarray(tq.float().numpy(), jnp.bfloat16),
                              jnp.asarray(tk.float().numpy(), jnp.bfloat16),
                              jnp.asarray(tv.float().numpy(), jnp.bfloat16),
                              jnp.asarray(lens), window=window), np.float32)
    n = case["S"] // case["pieces"]
    parts = [ops.decode_attention(tq, tk[:, i * n:(i + 1) * n],
                                  tv[:, i * n:(i + 1) * n], tl, window=window,
                                  key_offset=i * n, return_lse=True)
             for i in range(case["pieces"])]
    o, lse = merge_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
    got = o.to(bf).float().numpy()
    tol = 2 * 2.0 ** -8 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol
    # the merged log-sum-exp against numpy's over the valid scores
    s = np.einsum("bkgd,bskd->bkgs", tq.float().numpy().reshape(B, KV, -1,
                                                               HD),
                  tk.float().numpy()) / np.sqrt(HD)
    pos = np.arange(case["S"])[None]
    valid = (pos < lens[:, None]) & (
        pos >= lens[:, None] - (window or case["S"]))
    s = np.where(valid[:, None, None], s, -np.inf)
    ref_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(B, H), atol=1e-5)
    # a piece with no valid key: o = 0, lse = -inf, never NaN
    empty = 0
    for i, (po, pl) in enumerate(parts):
        lo, hi = i * n, (i + 1) * n
        none = ~valid[:, lo:hi].any(-1)
        assert torch.isfinite(po).all()
        assert (po[torch.tensor(none)] == 0).all()
        assert torch.isneginf(pl[torch.tensor(none)]).all()
        empty += int(none.sum())
    if name != "len_1":
        assert empty > 0
    whole, whole_lse = ops.decode_attention(tq, tk, tv, tl, window=window,
                                            return_lse=True)
    assert torch.equal(whole.to(bf), ops.decode_attention(tq, tk, tv, tl,
                                                          window=window))
    np.testing.assert_allclose(whole_lse.numpy(), ref_lse.reshape(B, H),
                               atol=1e-5)


# ---------------- lm.decode_step on a cache split over its sequence ------

ARCHS = {
    # a window short enough that the first pieces fall wholly before it
    "h2o-danube-1.8b": dict(sliding_window=6),
    "jamba-v0.1-52b": {},
}
S_MAX, STEPS = 32, 5
# one row (the long_500k cell's batch: the rule set splits the cache's
# sequence over "data" only where the rows cannot take it) prompted with
# 14 tokens: its writes at 14 to 18 cross the pieces' boundary at 16
PROMPT_LEN = 14


def _cfg(arch):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **ARCHS[arch])


def gloo(rank, world, store):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def _port_cache(cache_np):
    """The JAX cache (numpy, float k/v as f32) as the port's: float k/v in
    bf16, int8 codes as they are."""
    from repro_torch import weights
    c = weights.to_torch(cache_np, device="cpu")
    return [{k: (t.to(torch.bfloat16) if k in ("k", "v") and
                 t.dtype != torch.int8 else t)
             for k, t in sub.items()} for sub in c]


def _decode(arch, np_params, cache_np, toks, mesh=None, pieces=False):
    """``lm.decode_step`` teacher-forced over ``toks`` (B, STEPS): the
    logits of every step (numpy f32) and the final cache (plain tensors).
    With a mesh the params and cache are placed under the long-context
    rules and the activations follow ``LONG_CTX_ACT``; with ``pieces`` also
    a dict: for each attention layer's k and v, the global positions at
    which this rank's piece changed over the steps."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import weights
    from repro_torch.launch.train import distribute
    from repro_torch.models import lm
    from repro_torch.models.common import ShardCtx, logical_axes, tree_map
    from repro_torch.sharding import rules as R
    cfg = _cfg(arch)
    params = weights.model_params(np_params, "cpu")
    cache = _port_cache(cache_np)
    B = len(toks)
    kv_quant = any("k_scale" in sub for sub in cache_np)
    shard = None
    if mesh is not None:
        shard = ShardCtx(R.LONG_CTX_ACT, mesh)
        params = distribute(params, R.tree_shardings(
            R.LONG_CTX_PARAM, logical_axes(lm.model_spec(cfg)), mesh,
            params))
        cache = distribute(cache, R.tree_shardings(
            R.LONG_CTX_PARAM, logical_axes(lm.cache_spec(
                cfg, B, S_MAX, kv_quant=kv_quant)), mesh, cache))
    kv = [(j, k) for j, sub in enumerate(cache) for k in ("k", "v")
          if k in sub]
    before = {(j, k): cache[j][k].to_local().clone() for j, k in kv} \
        if pieces else {}
    out = []
    with torch.no_grad(), implicit_replication():
        for t in range(STEPS):
            tok = torch.from_numpy(toks[:, t]).long()
            if mesh is not None:
                tok = DTensor.from_local(tok, mesh, [Replicate(), Replicate()],
                                         run_check=False)
            kw = {} if shard is None else {"shard": shard}
            log, cache = lm.decode_step(params, cfg, tokens=tok, cache=cache,
                                        **kw)
            if mesh is not None:
                log = log.full_tensor()
            out.append(log.float().numpy())
        changed = {}
        for (j, k), old in before.items():
            new = cache[j][k]
            # (periods, B, S, KV, hd)
            at = R.local_slices(tuple(new.shape), mesh, new.placements)[2]
            diff = (new.to_local() != old).flatten(3).any(-1).flatten(
                0, 1).any(0)
            changed[f"{j}/{k}"] = at.start + np.flatnonzero(diff.numpy())
        if mesh is not None:
            cache = tree_map(lambda t: t.full_tensor()
                             if isinstance(t, DTensor) else t, cache)
    if pieces:
        return np.stack(out), cache, changed
    return np.stack(out), cache


def _split_rank(rank, world, store, tmp, arch, np_params, cache_np, toks):
    from repro_torch.launch.mesh import make_mesh
    gloo(rank, world, store)
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    logits, cache = _decode(arch, np_params, cache_np, toks, mesh)
    if rank == 0:
        np.savez(Path(tmp) / "split.npz", logits=logits,
                 **{f"{j}/{k}": t.float().numpy()
                    for j, sub in enumerate(cache) for k, t in sub.items()})
    dist.destroy_process_group()


def _fan_in(np_params, cfg):
    """q/k at the model's real fan-in (``tests/test_torch_families.py``'s
    ``_fan_in_and_bias``): at the package's draws attention is near
    one-hot and one bf16 ulp flips the key a query attends."""
    for sub in np_params["layers"]:
        if "attn" in sub:
            for name, heads in (("wq", cfg.num_heads),
                                ("wk", cfg.num_kv_heads)):
                sub["attn"][name] = sub["attn"][name] * np.float32(
                    (heads / cfg.d_model) ** 0.5)
    return np_params


@pytest.fixture(scope="module", params=sorted(ARCHS))
def jax_run(request):
    """The JAX package's prefill of right-padded prompts into a float cache
    of S_MAX positions and its unsplit decode steps teacher-forced over
    random tokens: (arch, numpy params, the cache after the prefill, the
    tokens, every step's logits, the final cache)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.models import lm as jlm
    arch = request.param
    cfg = dataclasses.replace(reduced(get_config(arch)), **ARCHS[arch])
    params = _fan_in(jax.tree.map(np.asarray, jlm.init_model(
        jax.random.PRNGKey(0), cfg)), cfg)
    rng = np.random.RandomState(1)
    jp = jax.tree.map(jnp.asarray, params)
    prompt = rng.randint(0, cfg.vocab_size, (1, PROMPT_LEN)).astype(np.int32)
    toks = rng.randint(0, cfg.vocab_size, (1, STEPS)).astype(np.int32)
    _, jc = jlm.prefill(jp, cfg, tokens=jnp.asarray(prompt),
                        cache=jlm.init_cache(cfg, 1, S_MAX))
    cache_np = jax.tree.map(lambda a: np.asarray(a, np.float32)
                            if a.dtype == jnp.bfloat16 else np.asarray(a), jc)
    want = []
    for t in range(STEPS):
        log, jc = jlm.decode_step(jp, cfg, tokens=jnp.asarray(toks[:, t]),
                                  cache=jc)
        want.append(np.asarray(log, np.float32))
    final = jax.tree.map(lambda a: np.asarray(a, np.float32), jc)
    return arch, params, cache_np, toks, np.stack(want), final


@pytest.mark.parametrize("world", [2, 4])
def test_split_decode_matches_jax(jax_run, world, tmp_path):
    """``lm.decode_step`` on ``world`` gloo ranks, the float cache split
    over its sequence (pieces of 16 or 8 positions), teacher-forced for 5
    steps whose writes cross a piece boundary: the logits against the port
    without a mesh and against the JAX package's unsplit decode; the
    lengths; the new tokens' K/V written by the rank whose piece holds
    each position, as in the mesh-less cache, and nothing written past
    the row's length."""
    arch, params, cache_np, toks, want, jfinal = jax_run
    store = str(tmp_path / "store")
    mp.spawn(_split_rank, args=(world, store, str(tmp_path), arch, params,
                                cache_np, toks), nprocs=world, join=True)
    got = np.load(tmp_path / "split.npz")
    plain, pcache = _decode(arch, params, cache_np, toks)
    assert np.isfinite(got["logits"]).all()
    _close(got["logits"], plain, MESH_TOL)
    _close(got["logits"], want, LOGIT_TOL)
    for j, sub in enumerate(pcache):
        for k, t in sub.items():
            mine = got[f"{j}/{k}"]
            if k == "len":
                np.testing.assert_array_equal(mine, t.numpy())
                np.testing.assert_array_equal(mine, jfinal[j][k])
            elif k in ("k", "v"):
                # the written positions hold the new tokens' K/V (within
                # the logits' noise: later layers see the merged
                # attention's rounding), and no rank wrote past a row's
                # length: those positions stay the prefill's zeros
                want_kv = t.float().numpy()
                _close(mine, want_kv, (MESH_TOL[0], 2 * 2.0 ** -7 *
                                       np.abs(want_kv).max()))
                n = PROMPT_LEN
                assert not mine[:, 0, n + STEPS:].any()
                assert np.abs(mine[:, 0, n:n + STEPS]).max(axis=(-1, -2)).all()


# ---------------- the same on an int8 cache (K3) ----------------

# K3 cases: K5's shapes (the same pieces, windows and lengths), int8 codes
K3_CASES = K5_CASES


@pytest.mark.parametrize("name", sorted(K3_CASES))
def test_k3_pieces_merge_to_jax_decode_attention_int8(name):
    """An int8 cache quantized by the JAX package's ``quantize_kv``, cut
    into pieces, each through ``ops.decode_attention_int8``'s plain version
    with its key offset and ``return_lse``, merged by ``merge_partials``:
    the JAX package's int8 decode kernel (Pallas, interpret mode) on the
    whole cache; empty pieces give o = 0 and lse = -inf; one piece at
    offset 0 rounds to the bits of a call without the log-sum-exp."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention_int8 import (decode_attention_int8,
                                                     quantize_kv)
    case = K3_CASES[name]
    window, S = case.get("window"), case["S"]
    q, k, v, lens = _k5_inputs(case, seed=2)
    q = torch.tensor(q).to(torch.bfloat16)
    qf = q.float().numpy()
    kq, vq, ks, vs = (np.asarray(a) for a in quantize_kv(
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3))))
    want = np.asarray(decode_attention_int8(
        jnp.asarray(qf), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(lens), window=window, block_s=16,
        interpret=True), np.float32)
    # the port's model layout (B, S, KV, hd)
    tk, tv = (torch.from_numpy(a.transpose(0, 2, 1, 3).copy())
              for a in (kq, vq))
    tks, tvs, tl = torch.from_numpy(ks), torch.from_numpy(vs), \
        torch.tensor(lens)
    n = S // case["pieces"]
    parts = [ops.decode_attention_int8(q, tk[:, i * n:(i + 1) * n],
                                       tv[:, i * n:(i + 1) * n], tks, tvs,
                                       tl, window=window, key_offset=i * n,
                                       return_lse=True)
             for i in range(case["pieces"])]
    o, lse = merge_partials(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
    assert np.abs(o.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    kd = kq.astype(np.float32) * ks[:, :, None, None]
    s = np.einsum("bkgd,bksd->bkgs", qf.reshape(B, KV, -1, HD), kd) / \
        np.sqrt(HD)
    pos = np.arange(S)[None]
    valid = (pos < lens[:, None]) & (pos >= lens[:, None] - (window or S))
    s = np.where(valid[:, None, None], s, -np.inf)
    ref_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + \
        s.max(-1)
    np.testing.assert_allclose(lse.numpy(), ref_lse.reshape(B, H),
                               atol=1e-5)
    for i, (po, pl) in enumerate(parts):
        none = torch.tensor(~valid[:, i * n:(i + 1) * n].any(-1))
        assert torch.isfinite(po).all()
        assert (po[none] == 0).all() and torch.isneginf(pl[none]).all()
    whole, _ = ops.decode_attention_int8(q, tk, tv, tks, tvs, tl,
                                         window=window, return_lse=True)
    assert torch.equal(whole.to(torch.bfloat16), ops.decode_attention_int8(
        q, tk, tv, tks, tvs, tl, window=window))


def _int8_cache(cache_np):
    """A float cache (numpy, the JAX prefill's) with each attention layer's
    K/V quantized by the JAX package's ``quantize_kv`` per (row, kv head),
    period by period: the dense int8 pool's layout and scales."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention_int8 import quantize_kv
    out = []
    for sub in cache_np:
        sub = dict(sub)
        if "k" in sub:
            per = [quantize_kv(jnp.asarray(k.transpose(0, 2, 1, 3)),
                               jnp.asarray(v.transpose(0, 2, 1, 3)))
                   for k, v in zip(sub["k"], sub["v"])]
            for i, name in enumerate(("k", "v", "k_scale", "v_scale")):
                a = np.stack([np.asarray(p[i]) for p in per])
                sub[name] = a.transpose(0, 1, 3, 2, 4) if i < 2 else a
        out.append(sub)
    return out


@pytest.fixture(scope="module")
def jax_int8_run(jax_run):
    """``jax_run``'s prefill quantized into a dense int8 cache and the JAX
    package's unsplit int8 decode teacher-forced over the same tokens."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import get_config, reduced
    from repro.models import lm as jlm
    arch, params, cache_np, toks, _, _ = jax_run
    jcfg = dataclasses.replace(reduced(get_config(arch)), **ARCHS[arch])
    cache8 = _int8_cache(cache_np)
    jp = jax.tree.map(jnp.asarray, params)
    jc = jax.tree.map(jnp.asarray, cache8)
    want = []
    for t in range(STEPS):
        log, jc = jlm.decode_step(jp, jcfg, tokens=jnp.asarray(toks[:, t]),
                                  cache=jc)
        want.append(np.asarray(log, np.float32))
    final = jax.tree.map(np.asarray, jc)
    return arch, params, cache8, toks, np.stack(want), final


def _split_rank_int8(rank, world, store, tmp, arch, np_params, cache_np,
                     toks):
    from repro_torch.launch.mesh import make_mesh
    gloo(rank, world, store)
    mesh = make_mesh((world, 1), ("data", "model"), "cpu")
    logits, cache, changed = _decode(arch, np_params, cache_np, toks, mesh,
                                     pieces=True)
    np.savez(Path(tmp) / f"changed{rank}.npz", **changed)
    if rank == 0:
        np.savez(Path(tmp) / "split.npz", logits=logits,
                 **{f"{j}/{k}": t.float().numpy()
                    for j, sub in enumerate(cache) for k, t in sub.items()})
    dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_split_int8_decode_matches_jax(jax_int8_run, world, tmp_path):
    """``lm.decode_step`` on ``world`` gloo ranks, the dense int8 cache
    split over its sequence (K3's pieces merged), teacher-forced for 5
    steps whose writes cross a piece boundary: the logits against the port
    without a mesh and against the JAX package's unsplit int8 decode; the
    lengths and scales exactly; the new tokens' codes written by the rank
    whose piece holds each position and by no other, nothing past the
    row's length."""
    arch, params, cache8, toks, want, jfinal = jax_int8_run
    store = str(tmp_path / "store")
    mp.spawn(_split_rank_int8, args=(world, store, str(tmp_path), arch,
                                     params, cache8, toks),
             nprocs=world, join=True)
    got = np.load(tmp_path / "split.npz")
    plain, pcache = _decode(arch, params, cache8, toks)
    assert np.isfinite(got["logits"]).all()
    _close(got["logits"], plain, MESH_TOL)
    _close(got["logits"], want, LOGIT_TOL)
    n, piece = PROMPT_LEN, S_MAX // world
    written = np.arange(n, n + STEPS)
    for j, sub in enumerate(pcache):
        for k, t in sub.items():
            mine = got[f"{j}/{k}"]
            if k in ("len", "k_scale", "v_scale"):
                np.testing.assert_array_equal(mine, t.float().numpy())
                np.testing.assert_array_equal(mine, jfinal[j][k])
            elif k in ("k", "v"):
                codes = t.float().numpy()
                assert np.abs(mine - codes).max() <= 1
                assert not mine[:, 0, n + STEPS:].any()
                assert np.abs(mine[:, 0, n:n + STEPS]).max(
                    axis=(-1, -2)).all()
                # each rank changed exactly the written positions it holds
                for r in range(world):
                    ch = np.load(tmp_path / f"changed{r}.npz")[f"{j}/{k}"]
                    held = written[(written >= r * piece) &
                                   (written < (r + 1) * piece)]
                    np.testing.assert_array_equal(ch, held)


# ---------------- the dry-run's long_500k cells ----------------

def test_long_500k_cells_on_256_fake_ranks():
    """h2o-danube-1.8b's and jamba's long_500k cells at their full 524288
    positions through the dry-run's ``run_one_cell`` on the 256-rank pod1
    mesh: ok, each rank's K5 calls reading at most its piece (32768
    positions; h2o's 4096-position window), and the merge's all-gather of
    the pieces' (o, lse) over the 16 "data" ranks counted."""
    code = """
        import json
        from repro_torch.launch import dryrun
        out = {a: dryrun.run_one_cell(a, "long_500k", "pod1")
               for a in ("h2o-danube-1.8b", "jamba-v0.1-52b")}
        print("RESULT " + json.dumps(out))
    """
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, (r.stdout + r.stderr)[-3000:]
    from repro_torch.configs import get_config
    from repro_torch.sharding.padding import pad_for_tp
    recs = json.loads(r.stdout.split("RESULT ", 1)[1])
    for arch, seen in {"h2o-danube-1.8b": 4096,
                       "jamba-v0.1-52b": 32768}.items():
        rec = recs[arch]
        assert rec["status"] == "ok" and rec["chips"] == 256, arch
        # the heads as the cell pads them for the 16-way "model" split
        cfg = pad_for_tp(get_config(arch), 16)
        heads = cfg.num_heads // 16 if cfg.num_kv_heads % 16 == 0 else \
            cfg.num_heads
        k5 = rec["cost_analysis_raw"]["decode_attention"]
        # the meta path's work per call: 4 * positions * H * hd FLOPs
        assert k5["flops"] == k5["calls"] * 4.0 * seen * heads * \
            cfg.head_dim, arch
        assert rec["collectives"]["all-gather"] > 0, arch
