"""K4's CUDA body (``csrc/int8_decode.cuh``: ``paged_decode_kernel``)
compiled by g++ for the CPU against the stand-in headers in
``tests/cuda_host/`` (``tests/_int8_host.py``) and run at the card's K3/K4
case shapes, cut to one kv head, against ``kernels.ref.
paged_decode_attention_ref``, which ``test_torch_paged.py`` holds against
the JAX package: the page lookup (a shift or a division), table entries
outside [0, P), lengths past the table. Tolerance: two bf16 ulps of the
largest output, as on the card. Skipped where g++ with C++20 is
missing."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

import _int8_host as h  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return h.build(tmp_path_factory, ("paged",))


@pytest.mark.parametrize("name", sorted(h.CASES))
def test_paged_kernel_body_matches_plain(host_lib, name):
    """K4's body through a table of pages of 16 (a shift), the arena in the
    model layout (P, ps, KV, hd), per-(page, h) scales."""
    B, H, KV, hd, S, lens, window, _ = h.CASES[name]
    gen = torch.Generator().manual_seed(12)
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    MP = -(-S // 16)
    _, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, 16, MP, lens)
    out = h.run_paged(host_lib, q, kp, vp, ks, vs, pt, ln, window)
    want = ref.paged_decode_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt, ln,
                                          window=window)
    want[ln <= 0] = 0
    h.check(out, want)


@pytest.mark.parametrize("ps,lens,window", [(12, [120, 7, 61], 50),
                                            (8, [200, 3, 40], None)])
def test_paged_kernel_body_page_sizes(host_lib, ps, lens, window):
    """A page size that is no power of two (the lookup divides) and one
    whose table a length overruns (positions past MP * ps are not read)."""
    gen = torch.Generator().manual_seed(13)
    B, H, KV, hd, MP = len(lens), 8, 4, 64, 10
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    _, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, ps, MP, lens)
    out = h.run_paged(host_lib, q, kp, vp, ks, vs, pt, ln, window)
    want = ref.paged_decode_attention_ref(q, kp.transpose(1, 2),
                                          vp.transpose(1, 2), ks, vs, pt,
                                          ln.clamp(max=MP * ps), window=window)
    h.check(out, want)


def test_paged_kernel_body_masks_entries_outside_the_arena(host_lib):
    """Table entries -1 and P are never dereferenced: their positions are
    masked, as if the stream did not hold them."""
    gen = torch.Generator().manual_seed(14)
    B, H, KV, hd, ps, MP = 3, 4, 2, 64, 16, 11
    lens = [176, 40, 100]
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    P, kp, vp, ks, vs, pt = h.paged_arena(gen, B, KV, hd, ps, MP, lens)
    pt[0, 0], pt[1, 1], pt[2, 6] = -1, P, 10 ** 6
    out = h.run_paged(host_lib, q, kp, vp, ks, vs, pt, ln, None)
    # the plain version on the arena with those pages' positions masked
    pos = torch.arange(MP * ps)
    page = pt.long()[:, pos // ps]                           # (B, MP * ps)
    keep = (page >= 0) & (page < P) & (pos[None] < ln[:, None])
    safe = page.clamp(0, P - 1)
    k = kp[safe, pos % ps].float() * ks[safe][..., None]    # (B, S, KV, hd)
    v = vp[safe, pos % ps].float() * vs[safe][..., None]
    qf = q.float().view(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(hd)
    s = s.masked_fill(~keep[:, None, None], float("-inf"))
    want = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1), v)
    h.check(out, want.reshape(B, H, hd).to(torch.bfloat16))
