"""The verify window on K4's split body (``csrc/int8_split_decode.cuh``:
``paged_verify_split_kernel``, the body of ``paged_split_kernel`` over T
window positions, their G T heads the rows of
the products in tiles of 16) compiled by g++ for the CPU against the
stand-in headers in ``tests/cuda_host/`` (``tests/_int8_host.py``) at
chip_smoke's ``VERIFY_CASES`` (T 1 to 10, windows that cross a page and a
cell, G 1 to 8), cut to one kv head, over cells small enough that several
cells and the merge run: each window position bit-identical to K4's split
body at its length (the form with rows 8-15 of a tile live against K4's
form without), and all within two bf16 ulps of the plain version. Also a
page size that 16 does not divide, table entries outside the arena, and
tiles whose position straddles two tiles. Skipped where g++ with C++20 is
missing."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

import _int8_host as h  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return h.build(tmp_path_factory, ("paged_split",))


def _per_position_k4(lib, q, kp, vp, ks, vs, pt, base, window, cell):
    """K4's split body at each window position's length."""
    return torch.stack([h.run_paged_split(lib, q[:, j].contiguous(), kp, vp,
                                          ks, vs, pt, base + j + 1, window,
                                          cell)
                        for j in range(q.shape[1])], dim=1)


def _check_window(lib, q, kp, vp, ks, vs, pt, bl, window, cell):
    out = h.run_paged_split(lib, q, kp, vp, ks, vs, pt, bl, window, cell,
                            lead=1)
    want = ref.paged_verify_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, bl,
                                          window=window)
    h.check(out, want)
    assert torch.equal(out, _per_position_k4(lib, q, kp, vp, ks, vs, pt, bl,
                                             window, cell))
    return out


@pytest.mark.parametrize("name", sorted(h.VERIFY_CASES))
def test_verify_split_body_bit_identical_to_k4(host_lib, name):
    """Every case, pages of 16, cut to one kv head (G kept), cells of 64
    keys (512 on the long tables): the plain version within two bf16
    ulps, and every position equal to K4's split body at base + j + 1 bit
    for bit."""
    c = h.VERIFY_CASES[name]
    G, T, MP, hd = c["H"] // c["KV"], c["T"], c["MP"], c.get("hd", 64)
    base, window = c["base"], c.get("window")
    B = len(base)
    gen = torch.Generator().manual_seed(41)
    q = torch.randn((B, T, G, hd), generator=gen).to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = h.verify_arena(gen, B, 1, hd, 16, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    _check_window(host_lib, q, kp, vp, ks, vs, pt, bl, window,
                  64 if MP * 16 <= 256 else 512)


@pytest.mark.parametrize("ps,cell,window", [(12, 64, 30), (12, 128, None),
                                            (8, 64, 30)])
def test_verify_split_body_page_size_and_outside_entries(host_lib, ps, cell,
                                                         window):
    """A page size that 16 does not divide or that is no power of two, a
    window whose positions run past the table (read up to MP ps only), and
    a table entry outside the arena (its positions masked: row 1's first
    position sees only position 0, on that page: zeros)."""
    gen = torch.Generator().manual_seed(42)
    B, H, KV, hd, MP, T = 3, 4, 2, 64, 6, 5
    base = [20, 0, 69]
    q = torch.randn((B, T, H, hd), generator=gen).to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = h.verify_arena(gen, B, KV, hd, ps, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    _check_window(host_lib, q, kp, vp, ks, vs, pt, bl, window, cell)
    pt[1, 0] = P                                 # never dereferenced
    out = h.run_paged_split(host_lib, q, kp, vp, ks, vs, pt, bl, None, cell,
                            lead=1)
    assert (out[1, 0].float() == 0).all()
    assert torch.equal(out, _per_position_k4(host_lib, q, kp, vp, ks, vs, pt,
                                             bl, None, cell))


@pytest.mark.parametrize("G,T", [(8, 10), (7, 5), (6, 7)])
def test_verify_split_body_tiles(host_lib, G, T):
    """Many tiles (G 8 at T 10: 80 rows, 5 tiles) and positions whose G
    heads straddle two tiles (G 7 and 6): each row takes its own
    position's q scale and length."""
    gen = torch.Generator().manual_seed(43)
    B, hd, MP = 2, 32, 8
    base = [50, 100]
    q = torch.randn((B, T, G, hd), generator=gen) * \
        torch.logspace(-2, 2, T)[None, :, None, None]
    q = q.to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = h.verify_arena(gen, B, 1, hd, 16, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    _check_window(host_lib, q, kp, vp, ks, vs, pt, bl, 40, 64)
