"""K3's CUDA bodies (``csrc/int8_decode.cuh``'s one-CTA
``decode_int8_kernel`` and ``csrc/int8_split_decode.cuh``'s split body and
merge) compiled by g++ for the CPU against the stand-in headers in
``tests/cuda_host/`` (``tests/_int8_host.py``) and run at the card's case
shapes, cut to one kv head, against the plain version in
``kernels/ref.py``, which ``test_torch_kernels.py`` holds against the JAX
package. Each case runs the body the wrapper's plan picks at the card's
shape (``decode_attention_int8.plan`` on an H100's 132 SMs): the one-CTA
body where the pairs fill the card over a short span, else the split body
with the card's number of splits. This checks the kernel's logic here,
where no GPU or nvcc is: the lane groups of every (hd, G) instantiation,
the rounds of passes and their second register buffer, windows, ragged and
empty rows, lengths past the cache; the split body's shares, stages and
merge. Tolerance: two bf16 ulps of the largest output, as on the card.
K4's body is in ``test_torch_int8_paged_host.py``, the verify window's in
``test_torch_int8_verify_host.py``, the split body's own cases and the
stand-ins of its primitives in ``test_torch_int8_split_host.py``. Skipped
where g++ with C++20 is missing."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention_int8 import plan  # noqa: E402

import _int8_host as h  # noqa: E402


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    return h.build(tmp_path_factory, ("dense", "split"))


@pytest.mark.parametrize("name", sorted(h.CASES))
def test_dense_kernel_body_matches_plain(host_lib, name):
    """K3's body on (B, KV, S, hd) views of the pool's (B, S, KV, hd) codes,
    per-(b, h) scales; a length past S reads S positions."""
    B, H, KV, hd, S, lens, window, card_kv = h.CASES[name]
    gen = torch.Generator().manual_seed(11)
    q, ln = h.inputs(gen, B, H, KV, hd, lens)
    kq, vq, ks, vs = h.dense_cache(gen, B, S, KV, hd)
    kh, vh = kq.transpose(1, 2), vq.transpose(1, 2)
    body, nsplit = plan(B, card_kv, H // KV, hd, S, window, 132)
    if body == "cta":
        out = torch.empty_like(q)
        rc = host_lib.host_decode_int8(
            q.data_ptr(), kh.data_ptr(), vh.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), ln.data_ptr(), out.data_ptr(), B, KV, H // KV, S,
            hd, *kh.stride()[:3], *vh.stride()[:3],
            -1 if window is None else window, 1 / math.sqrt(hd))
        assert rc == 0
    else:
        out = h.run_split(host_lib, q, kh, vh, ks, vs, ln, window, nsplit)
    want = ref.decode_attention_int8_ref(q, kh, vh, ks, vs, ln, window=window)
    want[ln <= 0] = 0              # the kernel's zeros for an empty row
    h.check(out, want)
