"""The verify window's CUDA body (``csrc/int8_decode.cuh``:
``paged_verify_kernel``, K4 over T window positions) compiled by g++ for
the CPU against the stand-in headers in ``tests/cuda_host/``
(``tests/_int8_host.py``) at chip_smoke's ``VERIFY_CASES`` (T 1 to 10,
windows that cross a page, G 1 to 8), cut to one kv head: its body in the
lean register form against the plain version and each window position
bit-identical to K4's body (K4's own form) at its length. Tolerance: two
bf16 ulps of the largest output, as on the card. Skipped where g++ with
C++20 is missing."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

import _int8_host as h  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return h.build(tmp_path_factory, ("paged", "verify"))


@pytest.mark.parametrize("name", sorted(h.VERIFY_CASES))
def test_verify_kernel_body_matches_plain(host_lib, name):
    """The verify window's body at chip_smoke's cases, cut to one kv head
    (G kept), against T single-token plain reads at the successive
    lengths base + j + 1, each position equal to K4's body at its length
    bit for bit (the lean register form against K4's)."""
    c = h.VERIFY_CASES[name]
    G, T, MP, hd = c["H"] // c["KV"], c["T"], c["MP"], c.get("hd", 64)
    base, window = c["base"], c.get("window")
    B = len(base)
    gen = torch.Generator().manual_seed(15)
    q = torch.randn((B, T, G, hd), generator=gen).to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = h.verify_arena(gen, B, 1, hd, 16, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    want = ref.paged_verify_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, bl,
                                          window=window)
    k4 = h.per_position_k4(host_lib, q, kp, vp, ks, vs, pt, bl, window)
    out = h.run_verify(host_lib, q, kp, vp, ks, vs, pt, bl, window)
    h.check(out, want)
    assert torch.equal(out, k4)


def test_verify_kernel_body_page_size_and_outside_entries(host_lib):
    """A page size that is no power of two (the lookup divides), a window
    whose positions run past the table (read up to MP * ps only) and a
    table entry outside the arena (its positions masked)."""
    gen = torch.Generator().manual_seed(16)
    B, H, KV, hd, ps, MP, T = 3, 4, 2, 64, 12, 6, 5
    base = [20, 0, 69]                          # row 2 runs past 72
    q = torch.randn((B, T, H, hd), generator=gen).to(torch.bfloat16)
    P, kp, vp, ks, vs, pt = h.verify_arena(gen, B, KV, hd, ps, MP, T, base)
    bl = torch.tensor(base, dtype=torch.int32)
    want = ref.paged_verify_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, bl,
                                          window=30)
    out = h.run_verify(host_lib, q, kp, vp, ks, vs, pt, bl, 30)
    h.check(out, want)
    pt[1, 0] = P                                 # never dereferenced
    k4 = h.per_position_k4(host_lib, q, kp, vp, ks, vs, pt, bl, None)
    out = h.run_verify(host_lib, q, kp, vp, ks, vs, pt, bl, None)
    assert torch.isfinite(out.float()).all()
    # row 1's first position sees only position 0, on the masked page: no
    # valid position, zeros
    assert (out[1, 0].float() == 0).all()
    assert torch.equal(out, k4)
