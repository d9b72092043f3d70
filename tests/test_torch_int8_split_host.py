"""K3's split body (``csrc/int8_split_decode.cuh``: ``decode_int8_split_
kernel`` and ``merge_kernel``) compiled by g++ for the CPU against the
stand-in headers in ``tests/cuda_host/`` (``tests/_int8_host.py``) and held
against the plain version ``kernels.ref.decode_attention_int8_ref``: every
(hd, G) instantiation with one split and with several (a split with no
valid key among them), windows whose span crosses split boundaries, rows of
length 0 and past the cache, warps whose ring of stages turns over, pieces
of a split cache at their key offsets with the log-sum-exp epilogue
(merged by ``merge_partials``), and two calls giving the same bits. Also
the stand-ins of the primitives that body uses (``mma.sync`` m16n8k16
f16 -> f32 by the PTX ISA's fragment layout, the f16 conversions, the
deferred 16-byte ``cp.async``) against plain products and copies, and the
wrapper's split plan (pure Python).

Tolerances: two bf16 ulps of the largest output, as on the card; a
piece's f32 output within 2^-9 of its largest value (p is rounded to f16
for P V) and its log-sum-exp within 1e-4 of the plain version's. Skipped
where g++ with C++20 is missing."""
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import decode_attention_int8 as k3  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.attention import merge_partials  # noqa: E402

import _int8_host as h  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return h.build(tmp_path_factory, ("split",))


def _ptr(a):
    return a.ctypes.data


def test_stand_in_mma_matches_a_plain_product(host_lib):
    """The mma.sync stand-in, fed fragments gathered by the PTX ISA's
    layout, gives C + A B of f16 A (16 x 16) and B (16 x 8) exactly (the
    products are exact in f32; small integers keep the sums exact)."""
    rng = np.random.default_rng(3)
    a = rng.integers(-60, 61, (16, 16)).astype(np.float16)
    b = rng.integers(-60, 61, (16, 8)).astype(np.float16)
    c = rng.integers(-1000, 1001, (16, 8)).astype(np.float32)
    d = np.zeros((16, 8), np.float32)
    host_lib.host_mma_f16(_ptr(a.view(np.uint16)), _ptr(b.view(np.uint16)),
                          _ptr(c), _ptr(d))
    np.testing.assert_array_equal(
        d, c + a.astype(np.float32) @ b.astype(np.float32))
    # fractions: within f32 rounding of the f64 product
    a = rng.standard_normal((16, 16)).astype(np.float16)
    b = rng.standard_normal((16, 8)).astype(np.float16)
    host_lib.host_mma_f16(_ptr(a.view(np.uint16)), _ptr(b.view(np.uint16)),
                          _ptr(c), _ptr(d))
    want = c + a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(d, want, rtol=1e-6, atol=1e-3)


def test_stand_in_f16_conversions(host_lib):
    """Every int8 code becomes its f16 value exactly (codes_f16x2: byte
    pairs 0-1 and 2-3 of a word); f16x2_pack rounds to nearest even as
    numpy's float16 does, subnormals and overflow included."""
    codes = np.arange(-128, 128, dtype=np.int8).reshape(-1, 4)
    words = codes.view(np.uint32).ravel()
    out = np.zeros(2 * words.size, np.uint32)
    host_lib.host_codes_f16(_ptr(words), _ptr(out), words.size)
    np.testing.assert_array_equal(out.view(np.float16).reshape(-1, 4),
                                  codes.astype(np.float16))
    rng = np.random.default_rng(4)
    f = np.concatenate([
        rng.standard_normal(4000) * 10.0 ** rng.integers(-9, 6, 4000),
        [0.0, -0.0, 65504.0, 65519.0, 65520.0, 1e6, 2.0 ** -24, 2.0 ** -25,
         3 * 2.0 ** -25, 1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -7e-6]
    ]).astype(np.float32)
    packed = np.zeros(f.size // 2, np.uint32)
    host_lib.host_pack_f16(_ptr(f), _ptr(packed), f.size // 2)
    with np.errstate(over="ignore"):            # 65520 and 1e6 become inf
        want = f.astype(np.float16)
    np.testing.assert_array_equal(packed.view(np.uint16), want.view(np.uint16))


def test_stand_in_cp_async_lands_at_its_wait(host_lib):
    """The 16-byte cp.async stand-in copies nothing until a wait covers its
    group: wait_group 1 leaves the newest group pending, wait_group 0
    lands every copy."""
    src = np.arange(16 * 10, dtype=np.uint8)
    dst = np.zeros_like(src)
    ready = np.zeros(2, np.int32)
    host_lib.host_cp_async(_ptr(src), _ptr(dst), 10, 4, _ptr(ready))
    assert ready.tolist() == [8, 10]          # groups of 4, 4, 2
    np.testing.assert_array_equal(dst, src)


# (G, hd) of every instantiation, at a cache of 200 positions: a full row,
# one of length 1 (its later splits hold no key), one of length 0 (zeros),
# one past S (S read)
_HD_G = [(hd, g) for hd in (32, 64, 80, 128) for g in (1, 2, 4, 6, 7, 8)]


def _case(seed, B, G, hd, S, lens, KV=1):
    gen = torch.Generator().manual_seed(seed)
    q, ln = h.inputs(gen, B, KV * G, KV, hd, lens)
    kq, vq, ks, vs = h.dense_cache(gen, B, S, KV, hd)
    return q, kq.transpose(1, 2), vq.transpose(1, 2), ks, vs, ln


def _want(q, kh, vh, ks, vs, ln, window, **kw):
    want = ref.decode_attention_int8_ref(q, kh, vh, ks, vs, ln,
                                         window=window, **kw)
    if not kw:
        want[ln <= 0] = 0
    return want


@pytest.mark.parametrize("hd,G", _HD_G, ids=[f"hd{a}_g{b}" for a, b in _HD_G])
def test_split_body_matches_plain(host_lib, hd, G):
    """One split and three (the merge launch) on the same inputs, two kv
    heads, within two bf16 ulps; the three-split call twice, bit for
    bit."""
    args = _case(21, 4, G, hd, 200, [200, 1, 0, 230], KV=2)
    want = _want(*args, None)
    h.check(h.run_split(host_lib, *args, None, 1), want)
    got = h.run_split(host_lib, *args, None, 3)
    h.check(got, want)
    assert torch.equal(got, h.run_split(host_lib, *args, None, 3))


@pytest.mark.parametrize("hd,G,window,nsplit", [
    (80, 4, 70, 3), (128, 8, 70, 4), (64, 1, 150, 5), (32, 7, 300, 2),
    (128, 6, 33, 2)])
def test_split_body_window_across_splits(host_lib, hd, G, window, nsplit):
    """A window whose span is cut by the splits' boundaries (each split a
    whole number of CTA passes of the row's own range), rows shorter than
    the window, a row with one key and a row past S."""
    lens = [400, 395, window - 1, window + 1, 1, 420]
    args = _case(22, len(lens), G, hd, 400, lens)
    want = _want(*args, window)
    h.check(h.run_split(host_lib, *args, window, nsplit), want)
    h.check(h.run_split(host_lib, *args, window, 1), want)


@pytest.mark.parametrize("hd", (32, 64, 80, 128))
def test_split_body_ring_turns_over(host_lib, hd):
    """Caches long enough that each warp walks more stages than its ring
    holds (four warps, three stages each), in one split and in two."""
    lens = [1100, 1033, 517, 5]
    args = _case(23, 4, 4, hd, 1100, lens)
    want = _want(*args, None)
    h.check(h.run_split(host_lib, *args, None, 1), want)
    h.check(h.run_split(host_lib, *args, None, 2), want)


@pytest.mark.parametrize("hd,G,window,nsplit", [
    (80, 4, 90, 3), (128, 4, None, 2), (64, 1, 40, 1), (128, 7, None, 4)])
def test_split_body_pieces_with_offset_and_lse(host_lib, hd, G, window,
                                               nsplit):
    """The split body on each of four pieces of a cache, at its key offset,
    with the log-sum-exp epilogue (through the merge for nsplit > 1): each
    piece's (o, lse) against the plain version's, a piece without a valid
    key o = 0 and lse = -inf; the pieces merged within two bf16 ulps of the
    whole cache's bf16 call."""
    S, npieces = 256, 4
    lens = [256, 150, 64, 65]
    q, kh, vh, ks, vs, ln = _case(24, 4, G, hd, S, lens)
    n = S // npieces
    parts = []
    for i in range(npieces):
        pk, pv = kh[:, :, i * n:(i + 1) * n], vh[:, :, i * n:(i + 1) * n]
        o, lse = h.run_split(host_lib, q, pk, pv, ks, vs, ln, window, nsplit,
                             key_offset=i * n, return_lse=True)
        want_o, want_lse = _want(q, pk, pv, ks, vs, ln, window,
                                 key_offset=i * n, return_lse=True)
        assert (o - want_o).abs().max() <= 2.0 ** -9 * want_o.abs().max() + 1e-7
        fin = torch.isfinite(want_lse)
        assert torch.equal(fin, torch.isfinite(lse))
        assert ((lse - want_lse).abs()[fin] <= 1e-4).all()
        assert (o[~fin] == 0).all() and torch.isneginf(lse[~fin]).all()
        parts.append((o, lse))
    assert any(not torch.isfinite(p[1]).all() for p in parts)
    merged, _ = merge_partials(torch.stack([p[0] for p in parts]),
                               torch.stack([p[1] for p in parts]))
    whole = h.run_split(host_lib, q, kh, vh, ks, vs, ln, window, nsplit)
    h.check(merged.to(torch.bfloat16), whole)
    h.check(whole, _want(q, kh, vh, ks, vs, ln, window))


def test_split_plan_depends_on_shapes_only():
    """The plan takes shapes (and the SM count), never lengths; it keeps
    the one-CTA body at stablelm's serving shape (256 pairs, 161
    positions); it plans a windowed call over its window, not the cache;
    splits are whole CTA passes of at least the minimum split, about two
    CTAs an SM; and a CUDA tensor's wrapper call takes it as is."""
    assert list(inspect.signature(k3.plan).parameters) == [
        "B", "KV", "G", "hd", "S", "window", "sms"]
    assert k3.plan(8, 32, 1, 64, 161, None, 132) == ("cta", 1)
    assert k3.plan(8, 8, 1, 64, 129, None, 132) == ("cta", 1)
    # qwen2-7b's pool: 32 pairs, 161 positions, 24 keys a round at G 7
    assert k3.plan(8, 4, 7, 128, 161, None, 132) == ("split", 1)
    # over the window: h2o's serving cache and its 524288-position one
    for S in (4200, 524288, 32768):
        assert k3.plan(8, 8, 4, 80, S, 4096, 132) == \
            k3.plan(8, 8, 4, 80, 4096, None, 132)
    body, n = k3.plan(1, 8, 4, 80, 524288, 4096, 132)
    assert body == "merge" and n * 8 <= 2 * 132
    assert 4096 // n >= k3._MIN_SPLIT and 4096 // n % k3.pass_keys(80) == 0
    body, n = k3.plan(1, 8, 4, 128, 524288, None, 132)
    assert body == "merge" and 2 * 132 <= n * 8 <= 2 * 132 + 8
    # a window past the cache plans over the cache
    assert k3.plan(2, 8, 4, 80, 1000, 4096, 132) == \
        k3.plan(2, 8, 4, 80, 1000, None, 132)


def test_split_meta_path_counts_the_workspace(monkeypatch):
    """On meta tensors K3 reports its plan's partials (written once, read
    once by the merge) beside the cache's bytes, planned for an H100."""
    seen = []
    monkeypatch.setattr(ops, "META_WORK", lambda *a: seen.append(a))
    m = dict(device="meta")
    B, KV, G, hd, S = 1, 8, 4, 128, 524288
    q = torch.empty(B, KV * G, hd, dtype=torch.bfloat16, **m)
    k8 = torch.empty(B, S, KV, hd, dtype=torch.int8, **m)
    sc = torch.empty(B, KV, **m)
    lens = torch.empty(B, dtype=torch.int32, **m)
    ops.decode_attention_int8(q, k8, k8, sc, sc, lens)
    _, n = k3.plan(B, KV, G, hd, S, None, k3._META_SMS)
    work = 2 * 4 * k3.workspace_floats(B, KV, G, hd, n)
    assert work > 0
    assert seen == [("decode_attention_int8", 4.0 * B * S * KV * G * hd,
                     (2 + 2) * B * KV * G * hd + 2 * B * S * KV * hd
                     + 2 * 4 * B * KV + 4 * B + work)]
