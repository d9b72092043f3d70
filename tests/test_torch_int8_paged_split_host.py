"""K4's split body (``csrc/int8_split_decode.cuh``: ``paged_split_kernel``
and ``paged_merge_kernel``) compiled by g++ for the CPU against the
stand-in headers in ``tests/cuda_host/`` (``tests/_int8_host.py``) and held
against the plain version ``kernels.ref.paged_decode_attention_ref``, which
``test_torch_paged.py`` holds against the JAX package: chip_smoke's K3/K4
cases cut to one kv head, each over cells small enough that several cells
and the merge run; page sizes that are no power of two or that 16 does not
divide (a chunk across two pages' scales); table entries outside [0, P);
rows of length 0 and cells that no row meets; and two calls giving the same
bits. Also the wrapper's plan (pure Python: shapes only, the cells a window
meets) and its meta path.

Tolerance: two bf16 ulps of the largest output, as on the card. Skipped
where g++ with C++20 is missing."""
import inspect
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import paged_decode_attention as k4  # noqa: E402

import _int8_host as h  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return h.build(tmp_path_factory, ("paged_split",))


def _want(q, kp, vp, ks, vs, pt, ln, window):
    MP, ps = pt.shape[1], kp.shape[1]
    want = ref.paged_decode_attention_ref(
        q, kp.transpose(1, 2), vp.transpose(1, 2), ks, vs, pt,
        ln.clamp(max=MP * ps), window=window)
    want[ln <= 0] = 0
    return want


@pytest.mark.parametrize("name", sorted(h.CASES))
def test_paged_split_body_matches_plain(host_lib, name):
    """The split body at every K3/K4 case, pages of 16, cells of 64 keys
    (several cells, the merge; 512 on the long caches), within two bf16
    ulps; the same bits from a second call."""
    B, H, KV, hd, S, lens, window, _ = h.CASES[name]
    gen = torch.Generator().manual_seed(31)
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    MP = -(-S // 16)
    _, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, 16, MP, lens)
    cell = 64 if S <= 256 else 512
    assert k4.cells(MP * 16, window, 1, cell) > 1
    args = (q, kp, vp, ks, vs, pt, ln, window, cell)
    out = h.run_paged_split(host_lib, *args)
    h.check(out, _want(q, kp, vp, ks, vs, pt, ln, window))
    assert torch.equal(out, h.run_paged_split(host_lib, *args))


@pytest.mark.parametrize("ps,lens,window,cell", [
    (12, [120, 7, 61, 100], 50, 64), (8, [200, 3, 40, 77], None, 64),
    (12, [119, 120, 1, 97], 40, 128), (32, [300, 31, 33, 64], 100, 64)])
def test_paged_split_body_page_sizes(host_lib, ps, lens, window, cell):
    """Page sizes that are no power of two (the lookup divides) and that 16
    does not divide (a 16-key chunk then spans two pages: P V in one
    segment a page, each at its own v scale), a window across page and
    cell boundaries, and a table that a length overruns (positions past MP
    ps are not read)."""
    gen = torch.Generator().manual_seed(32)
    B, H, KV, hd, MP = len(lens), 8, 2, 64, 10
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    _, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, ps, MP, lens)
    out = h.run_paged_split(host_lib, q, kp, vp, ks, vs, pt, ln, window,
                            cell)
    h.check(out, _want(q, kp, vp, ks, vs, pt, ln, window))


def test_paged_split_body_masks_entries_outside_the_arena(host_lib):
    """Table entries -1, P and 10**6 are never dereferenced: their
    positions are masked, as if the stream did not hold them."""
    gen = torch.Generator().manual_seed(33)
    B, H, KV, hd, ps, MP = 3, 4, 2, 128, 16, 11
    lens = [176, 40, 100]
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    P, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, ps, MP, lens)
    pt[0, 0], pt[1, 1], pt[2, 6] = -1, P, 10 ** 6
    out = h.run_paged_split(host_lib, q, kp, vp, ks, vs, pt, ln, None, 64)
    pos = torch.arange(MP * ps)
    page = pt.long()[:, pos // ps]
    keep = (page >= 0) & (page < P) & (pos[None] < ln[:, None])
    safe = page.clamp(0, P - 1)
    k = kp[safe, pos % ps].float() * ks[safe][..., None]
    v = vp[safe, pos % ps].float() * vs[safe][..., None]
    qf = q.float().view(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(hd)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    want = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v)
    h.check(out, want.reshape(B, H, hd).to(torch.bfloat16))


def test_paged_split_body_empty_rows_and_cells(host_lib):
    """A row of length 0 gives zeros; a short row under a long table meets
    one cell of many (the rest write empty partials, which the merge
    skips); one cell holding the whole table writes the output itself."""
    gen = torch.Generator().manual_seed(34)
    B, H, KV, hd, MP = 4, 16, 2, 80, 20
    lens = [0, 5, 320, 129]
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    _, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, 16, MP, lens)
    want = _want(q, kp, vp, ks, vs, pt, ln, None)
    for cell in (64, 320):
        out = h.run_paged_split(host_lib, q, kp, vp, ks, vs, pt, ln, None,
                                cell)
        h.check(out, want)
        assert (out[0].float() == 0).all()


def test_paged_split_plan_depends_on_shapes_only():
    """The plan takes shapes (and the SM count), never lengths; it keeps
    the one-CTA body at stablelm's and whisper's pools; qwen2-7b's and
    jamba's groups take the split body, one cell; h2o-danube's window takes
    cells that a window's range meets at most 2 CTAs an SM, counting the
    extra cell; cells are whole CTA passes within the bounds; the verify
    window's positions meet at most one cell more. ``split_for`` derives
    each call's launch from the plan alone, for K4 and the verify window
    alike."""
    assert list(inspect.signature(k4.plan).parameters) == [
        "B", "KV", "G", "hd", "S", "window", "sms"]
    for MP in (11, 13):
        assert k4.plan(8, 32, 1, 64, MP * 16, None, 132) == ("cta", 0)
        assert k4.plan(8, 32, 1, 64, MP * 16, 48, 132) == ("cta", 0)
        for T in (1, 5):
            assert k4.split_for(8, 32, 1, 64, MP * 16, None, T, 132) == \
                ("cta", 0, 0, 0)
    assert k4.plan(8, 8, 1, 64, 9 * 16, None, 132) == ("cta", 0)
    for G, hd, KV in ((7, 128, 4), (4, 128, 8)):
        body, cell = k4.plan(8, KV, G, hd, 176, None, 132)
        assert body == "split" and cell >= 176
        assert k4.split_for(8, KV, G, hd, 176, None, 1, 132) == \
            ("split", 1, cell, 0)
    body, cell = k4.plan(8, 8, 4, 80, 263 * 16, 4096, 132)
    sp = k4.split_for(8, 8, 4, 80, 263 * 16, 4096, 1, 132)
    n = sp.nsplit
    assert body == "split" and sp.body == "merge" and sp.cell == cell
    assert 2 <= n and 8 * 8 * n <= 2 * 132
    assert cell % 64 == 0 and k4._MIN_CELL <= cell <= k4._MAX_CELL
    assert n == k4.cells(263 * 16, 4096, 1, cell) == \
        min(-(-263 * 16 // cell), 4095 // cell + 2)
    assert sp.work == k4.workspace_floats(8, 8, 4, 80, n)
    sv = k4.split_for(8, 8, 4, 80, 264 * 16, 4096, 5, 132)
    assert sv.body == "merge" and sv.cell == cell and sv.nsplit <= n + 1
    assert sv.nsplit == k4.cells(264 * 16, 4096, 5, cell)
    assert sv.work == k4.workspace_floats(8, 8, 5 * 4, 80, sv.nsplit)
    # a window at least the table plans over the table (ranges from 0)
    assert k4.plan(2, 8, 4, 80, 1000 // 16 * 16, 4096, 132) == \
        k4.plan(2, 8, 4, 80, 1000 // 16 * 16, None, 132)
    assert k4.cells(1024, None, 5, 256) == 4


def test_paged_meta_path_counts_the_workspace(monkeypatch):
    """On meta tensors K4 and the verify window report their plan's
    partials (written once, read once by the merge) beside the arena's
    bytes, planned for an H100; one cell or the one-CTA body adds none."""
    seen = []
    monkeypatch.setattr(ops, "META_WORK", lambda *a: seen.append(a))
    m = dict(device="meta")
    B, KV, G, hd, MP, ps, T = 8, 8, 4, 80, 264, 16, 5
    pages = torch.empty(1 + B * MP, ps, KV, hd, dtype=torch.int8, **m)
    sc = torch.empty(1 + B * MP, KV, **m)
    pt = torch.empty(B, MP, dtype=torch.int32, **m)
    lens = torch.empty(B, dtype=torch.int32, **m)
    q = torch.empty(B, KV * G, hd, dtype=torch.bfloat16, **m)
    qv = torch.empty(B, T, KV * G, hd, dtype=torch.bfloat16, **m)
    ops.paged_decode_attention(q, pages, pages, sc, sc, pt, lens, window=4096)
    ops.paged_verify_attention(qv, pages, pages, sc, sc, pt, lens,
                               window=4096)
    _, cell = k4.plan(B, KV, G, hd, MP * ps, 4096, k4._META_SMS)
    n = 4096 * B
    pg = -(-n // ps)
    base = 2 * pg * ps * KV * hd + 2 * 4 * pg * KV + 4 * B * MP + 4 * B
    work = [2 * 4 * k4.workspace_floats(B, KV, t * G, hd, k4.cells(
        MP * ps, 4096, t, cell)) for t in (1, T)]
    assert all(w > 0 for w in work)
    assert seen == [
        ("paged_decode_attention", 4.0 * n * KV * G * hd,
         base + 2 * 2 * B * KV * G * hd + work[0]),
        ("paged_verify_attention", 4.0 * T * n * KV * G * hd,
         base + 2 * 2 * B * T * KV * G * hd + work[1])]
    seen.clear()
    small = torch.empty(9, 16, 2, 64, dtype=torch.int8, **m)
    ops.paged_decode_attention(torch.empty(2, 2, 64, dtype=torch.bfloat16,
                                           **m), small, small,
                               torch.empty(9, 2, **m),
                               torch.empty(9, 2, **m),
                               torch.empty(2, 4, dtype=torch.int32, **m),
                               torch.empty(2, dtype=torch.int32, **m))
    assert k4.plan(2, 2, 1, 64, 64, None, k4._META_SMS)[0] == "cta"
    assert seen[0][2] == (2 * 8 * 16 * 2 * 64 + 2 * 4 * 8 * 2 + 4 * 2 * 4
                          + 2 * 2 * 2 * 2 * 64 + 4 * 2)
