"""The port's kernel modules against the JAX package's: the plain PyTorch
versions of the SGMV and int8 flash-decode kernels (and ``quantize_kv``)
against ``repro.kernels.ref`` on the shape sweeps of ``test_kernels.py``,
plus rectangular outputs, sentinel blocks, ragged cache lengths and a
window; the host-side sort helpers against the JAX ones; and, on a GPU only,
the CUDA kernels against their plain versions."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import segmented_lora as jsgmv  # noqa: E402
from repro.kernels.decode_attention_int8 import quantize_kv as jquantize  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import segmented_lora as sgmv  # noqa: E402
from repro_torch.kernels.decode_attention_int8 import quantize_kv  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
# the one K3/K4 case table, shared with chip_smoke.py's card check
from chip_smoke import INT8_CASES  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores, and some JAX tests time their own calibration."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# f32: both sides compute the same f32 products, summed in another order.
# bf16: the same f32 result is rounded to bf16 on both sides, so an order
# difference can flip the last bf16 bit: one ulp is 2^-8 relative.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _pair(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.tensor(x).to(td)


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("T,d,r,NA,bt,out", [(256, 128, 16, 5, 32, 128),
                                             (128, 256, 8, 2, 64, 256),
                                             (64, 64, 4, 1, 64, 64),
                                             (96, 64, 16, 4, 16, 96),
                                             (64, 256, 16, 3, 16, 3584),
                                             (64, 256, 16, 3, 16, 512),
                                             (64, 256, 16, 3, 16, 640),
                                             (64, 256, 16, 3, 16, 8192)])
def test_segmented_lora_ref_matches_jax(T, d, r, NA, bt, out, dtype):
    """Square and rectangular outputs (the last four: the q and v widths
    of qwen2-7b, 3584 and 512, h2o-danube-1.8b's v, 640, and qwen2-vl's
    q, 8192); block ids include the sentinel NA (and a larger one), whose
    blocks must come out zero."""
    rng = np.random.RandomState(2)
    x = rng.randn(T, d).astype(np.float32)
    a = (rng.randn(NA, d, r) * 0.05).astype(np.float32)
    b = (rng.randn(NA, r, out) * 0.05).astype(np.float32)
    ids = rng.randint(0, NA + 1, T // bt).astype(np.int32)
    ids[-1] = NA + 7                                  # beyond the sentinel
    jx, tx = _pair(x, dtype)
    ja, ta = _pair(a, dtype)
    jb, tb = _pair(b, dtype)
    want = jref.segmented_lora_ref(jx, jnp.asarray(ids), ja, jb, bt)
    got = ref.segmented_lora_ref(tx, torch.tensor(ids), ta, tb, bt)
    assert got.dtype == tx.dtype and tuple(got.shape) == (T, out)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    zero = _np(got).reshape(-1, bt, out)[ids >= NA]
    assert not zero.any()
    # the CPU route of the op is the plain version
    np.testing.assert_array_equal(
        _np(ops.segmented_lora(tx, torch.tensor(ids), ta, tb, block_t=bt)),
        _np(got))


def test_quantize_kv_matches_jax():
    """Same codes and scales (symmetric, max|x|/127, clip +-127), exactly:
    both sides divide the same f32 values and round half to even."""
    rng = np.random.RandomState(0)
    k = (rng.randn(2, 3, 37, 16) * 2.0).astype(np.float32)
    v = rng.randn(2, 3, 37, 16).astype(np.float32)
    v[1, 2] = 0.0                                     # an all-zero head
    want = jquantize(jnp.asarray(k), jnp.asarray(v))
    got = quantize_kv(torch.tensor(k), torch.tensor(v))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the model-layout adapter agrees with the JAX one too
    km, vm = k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3)
    want_m = jops.quantize_kv(jnp.asarray(km), jnp.asarray(vm))
    got_m = ops.quantize_kv(torch.tensor(km), torch.tensor(vm))
    for g, w in zip(got_m, want_m):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("B,H,KV,S,hd", [(2, 8, 2, 256, 64), (1, 4, 4, 128, 32),
                                         (3, 28, 4, 128, 128),
                                         (3, 32, 8, 128, 80),
                                         (8, 4, 4, 161, 16), (3, 4, 2, 37, 32)])
@pytest.mark.parametrize("window", [None, 48])
def test_decode_attention_int8_ref_matches_jax(B, H, KV, S, hd, window):
    """Ragged S (161, 37: no block multiple), lengths from 1 to S, GQA and
    MHA (qwen2-7b's group of 7 at hd 128, h2o-danube-1.8b's hd 80), with
    and without a window. f32 on both sides: 1e-5."""
    rng = np.random.RandomState(3)
    q = rng.randn(B, H, hd).astype(np.float32)
    k = rng.randn(B, KV, S, hd).astype(np.float32)
    v = rng.randn(B, KV, S, hd).astype(np.float32)
    lens = rng.randint(1, S + 1, B).astype(np.int32)
    lens[0] = S
    kq, vq, ks, vs = (np.asarray(t) for t in jquantize(jnp.asarray(k),
                                                       jnp.asarray(v)))
    want = jref.decode_attention_int8_ref(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(lens), window=window)
    t = [torch.tensor(a) for a in (q, kq, vq, ks, vs, lens)]
    got = ref.decode_attention_int8_ref(*t, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # model-layout op (CPU route) vs the JAX op's XLA path
    km, vm = kq.transpose(0, 2, 1, 3), vq.transpose(0, 2, 1, 3)
    want_m = jops.decode_attention_int8(
        jnp.asarray(q), jnp.asarray(km), jnp.asarray(vm), jnp.asarray(ks),
        jnp.asarray(vs), jnp.asarray(lens), window=window, backend="xla")
    got_m = ops.decode_attention_int8(
        torch.tensor(q), torch.tensor(km), torch.tensor(vm), torch.tensor(ks),
        torch.tensor(vs), torch.tensor(lens), window=window)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("n,na,bt,seed", [(173, 6, 16, 1), (8, 4, 16, 2),
                                          (64, 3, 8, 3), (1, 1, 4, 4)])
def test_host_helpers_match_jax(n, na, bt, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, na + 1, n).astype(np.int32)
    segs = min(n, na + 2)
    tp = sgmv.padded_tokens(n, segs, bt)
    assert tp == jsgmv.padded_tokens(n, segs, bt)
    for a, b in zip(sgmv.sort_by_adapter(ids, na, bt, tp),
                    jsgmv.sort_by_adapter(ids, na, bt, tp)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sgmv.segment_metadata(ids, na, bt, tp),
                    jsgmv.segment_metadata(ids, na, bt, tp)):
        np.testing.assert_array_equal(a, b)
    cache = sgmv.SegmentMetaCache(maxsize=2)
    first = cache.get(ids, na, bt, tp)
    assert cache.get(ids, na, bt, tp) is first and cache.builds == 1
    cache.get(ids + 1, na + 1, bt, tp)
    cache.get(ids + 2, na + 2, bt, tp)             # evicts the first entry
    cache.get(ids, na, bt, tp)
    assert cache.builds == 4


def test_cpu_route_only_for_cpu_tensors():
    """The ops take the plain version only for CPU tensors; any other device
    raises instead of falling back (meta tensors stand in for one here)."""
    x = torch.empty((16, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.segmented_lora(x, torch.zeros(1, dtype=torch.int32),
                           torch.empty((1, 8, 4)), torch.empty((1, 4, 8)),
                           block_t=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgmv.segmented_lora(torch.zeros((16, 8), dtype=torch.bfloat16),
                            torch.zeros(1, dtype=torch.int32),
                            torch.zeros((1, 8, 4)), torch.zeros((1, 4, 8)),
                            block_t=16)


SGMV_SHAPES = {                 # (token blocks of 16, d), stablelm / whisper
    "decode": (6, 2048), "prefill": (13, 2048), "pooled": (261, 2048),
    "whisper_decode": (6, 512), "one_block": (1, 2048), "narrow": (4, 96),
    "fills_card": (132, 2048)}


@pytest.mark.parametrize("sms", [132, 66])
@pytest.mark.parametrize("name", sorted(SGMV_SHAPES))
def test_segmented_lora_d_split_plan(name, sms):
    """The shrink's d-split: the splits cover [0, d) in order with no gap,
    no overlap and no empty split, each a multiple of 8 rows; at decode the
    shrink CTAs number between half and two an SM (16 splits of 128 rows on
    132 SMs, the plan measured fastest on an H100: more splits only add
    partials for the expand to sum), at most 16 splits; one split once the
    blocks alone fill the card (pooled); the SM count is a parameter."""
    nb, d = SGMV_SHAPES[name]
    n, split_len = sgmv.d_splits(nb, d, sms)
    assert split_len % 8 == 0 and 1 <= n <= 16
    spans = [(i * split_len, min((i + 1) * split_len, d)) for i in range(n)]
    assert spans[0][0] == 0 and spans[-1][1] == d
    assert all(hi > lo for lo, hi in spans)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    if nb >= sms:
        assert n == 1
    if name == "decode":
        assert sms / 2 <= nb * n <= 2 * sms
    if (name, sms) == ("decode", 132):
        assert (n, split_len) == (16, 128)
    if name == "pooled":
        assert n == 1


def test_segmented_lora_plan_takes_shapes_only():
    """The d-split is a function of the shapes and the SM count alone, so
    choosing it needs no host sync: the planner takes no tensor, and the
    wrapper's one call of it is built from shape names and the device index
    only (no read of a tensor's values)."""
    import ast
    import inspect
    assert list(inspect.signature(sgmv.d_splits).parameters) == \
        ["num_blocks", "d", "sms"]
    tree = ast.parse(inspect.getsource(sgmv.segmented_lora))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "d_splits"]
    assert len(calls) == 1
    nodes = [n for a in calls[0].args for n in ast.walk(a)]
    names = {n.id for n in nodes if isinstance(n, ast.Name)}
    attrs = {n.attr for n in nodes if isinstance(n, ast.Attribute)}
    assert names <= {"nb", "d", "build", "x"}, names
    assert attrs <= {"sm_count", "device", "index"}, attrs


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels are built and run on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,r,NA,bt,out", [(96, 2048, 16, 4, 16, 2048),
                                             (256, 128, 16, 5, 32, 96),
                                             (96, 512, 16, 4, 16, 512),
                                             (96, 2048, 4, 4, 16, 2048),
                                             (96, 2048, 64, 4, 16, 2048),
                                             (96, 2048, 16, 1, 16, 96),
                                             (4176, 2048, 16, 4, 16, 2048),
                                             (64, 256, 8, 3, 16, 90)])
def test_segmented_lora_kernel_on_gpu(cuda_device, T, d, r, NA, bt, out):
    """CUDA kernel vs its plain version, bf16 in/out: two bf16 ulps of the
    largest output (both accumulate in f32, in another order), at the
    stablelm and whisper decode shapes, ranks 4 to 64, one adapter, an
    output narrower than d or not a multiple of 4, the pooled shape; the
    same bits from a second call."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((T, d), generator=gen, device=cuda_device).to(torch.bfloat16)
    a = torch.randn((NA, d, r), generator=gen, device=cuda_device) * 0.05
    b = torch.randn((NA, r, out), generator=gen, device=cuda_device) * 0.05
    ids = torch.randint(0, NA + 1, (T // bt,), generator=gen,
                        device=cuda_device, dtype=torch.int32)
    before = ops.LAUNCHES["segmented_lora"]
    got = ops.segmented_lora(x, ids, a, b, block_t=bt)
    want = ref.segmented_lora_ref(x, ids, a, b, bt)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["segmented_lora"] == before + 1
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, ops.segmented_lora(x, ids, a, b, block_t=bt))
    assert bool((got.view(-1, bt, out)[ids >= NA] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(INT8_CASES))
def test_decode_attention_int8_kernel_on_gpu(cuda_device, case):
    """CUDA kernel vs its plain version (the cache in the pool's layout,
    read through the transposed view; S = 161 is ragged and a length past
    S reads S positions): two bf16 ulps of the largest output, and the same
    bits from a second call."""
    c = INT8_CASES[case]
    H, KV, hd, S, lens, window = (c["H"], c["KV"], c.get("hd", 64), c["S"],
                                  c["lens"], c.get("window"))
    B = len(lens)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn((B, H, hd), generator=gen, device=cuda_device).to(torch.bfloat16)
    k = torch.randn((B, S, KV, hd), generator=gen, device=cuda_device)
    v = torch.randn((B, S, KV, hd), generator=gen, device=cuda_device)
    kq, vq, ks, vs = ops.quantize_kv(k, v)
    kq, vq = kq.contiguous(), vq.contiguous()
    lens = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    before = ops.LAUNCHES["decode_attention_int8"]
    got = ops.decode_attention_int8(q, kq, vq, ks, vs, lens, window=window)
    want = ref.decode_attention_int8_ref(q, kq.transpose(1, 2),
                                         vq.transpose(1, 2), ks, vs, lens,
                                         window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["decode_attention_int8"] == before + 1
    tol = 2 * 2.0 ** -8 * want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, ops.decode_attention_int8(q, kq, vq, ks, vs, lens,
                                                      window=window))


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library is named by its source AND the headers it includes from
    csrc/ (recursively), so an edit to a header shared by two kernels
    rebuilds both; a header it does not include, or an angle-bracket
    include, does not move the name."""
    from repro_torch.kernels import build
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n#include <x.h>\n'
                                   "int a;\n")
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\nint b;\n')
    (tmp_path / "shared.cuh").write_text('#include "inner.cuh"\n// v1\n')
    (tmp_path / "inner.cuh").write_text("// inner v1\n")
    (tmp_path / "other.cuh").write_text("// other v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"a": "a.cu", "b": "b.cu"})
    before = {n: build.library_path(n) for n in ("a", "b")}
    (tmp_path / "other.cuh").write_text("// other v2\n")
    assert {n: build.library_path(n) for n in ("a", "b")} == before
    (tmp_path / "inner.cuh").write_text("// inner v2\n")
    after = {n: build.library_path(n) for n in ("a", "b")}
    assert after["a"] != before["a"] and after["b"] != before["b"]
    (tmp_path / "shared.cuh").write_text('#include "inner.cuh"\n// v2\n')
    assert build.library_path("a") not in (before["a"], after["a"])
    assert build.library_path("a").name.startswith("a-")


def test_build_all_runs_sources_together_and_times_each(tmp_path,
                                                        monkeypatch):
    """``build_all`` starts one compiler a source (a source in PARTS: one
    object a part, each with its -DKERNEL_PART, then a link), keeps the
    output as ``<name>.log``, records each build's seconds, moves each
    library into place, skips what is built, and raises with the output of
    a failed build (a shell script stands in for nvcc)."""
    from repro_torch.kernels import build
    for n in ("a", "b", "bad"):
        (tmp_path / f"{n}.cu").write_text(f"int {n};\n")
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nsrc=""; out=""; objs=""; part=""\n'
                    'while [ $# -gt 0 ]; do case "$1" in -o) out="$2"; '
                    'shift;; *.cu) src="$1";; *.o) objs="$objs $1";; '
                    '-DKERNEL_PART=*) part="$1";; esac; shift; done\n'
                    'if [ -z "$src" ]; then echo "link"; cat $objs > "$out"; '
                    'exit 0; fi\necho "ptxas info for $src $part"\n'
                    'case "$src" in *bad.cu) echo "error: bad" >&2; '
                    'exit 2;; esac\n{ cat "$src"; echo "$part"; } > "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "SOURCES", {n: f"{n}.cu"
                                           for n in ("a", "b", "bad")})
    monkeypatch.setattr(build, "PARTS", {"b": 3})
    monkeypatch.setattr(build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "BUILD_SECONDS", {})
    libs = build.build_all(["a", "b"])
    assert libs["a"].read_text() == "int a;\n\n"
    assert libs["b"].read_text() == "".join(f"int b;\n-DKERNEL_PART={i}\n"
                                            for i in range(3))
    assert set(build.BUILD_SECONDS) == {"a", "b"}
    assert all(s >= 0 for s in build.BUILD_SECONDS.values())
    assert "ptxas info for" in (tmp_path / "out" / "a.log").read_text()
    blog = (tmp_path / "out" / "b.log").read_text()
    assert blog.count("ptxas info for") == 3 and blog.endswith("link\n")
    assert not list((tmp_path / "out").glob("*.o"))
    build.BUILD_SECONDS.clear()
    assert build.build_all(["a", "b"]) == libs and not build.BUILD_SECONDS
    with pytest.raises(RuntimeError, match="bad: nvcc failed"):
        build.build_all()
    assert not build.library_path("bad").exists()
    assert not list((tmp_path / "out").glob("*.tmp*"))


def test_int8_decode_sources_share_one_header():
    """K3 and K4 are one kernel body: both sources include
    int8_decode.cuh, which defines both kernels, and each keeps its own
    extern "C" entry point."""
    from repro_torch.kernels import build
    header = (build.CSRC / "int8_decode.cuh").read_text()
    assert "decode_int8_kernel" in header and "paged_decode_kernel" in header
    for name, entry in (("decode_attention_int8", "decode_int8_launch"),
                        ("paged_decode_attention", "paged_decode_launch")):
        src = (build.CSRC / build.SOURCES[name]).read_text()
        assert '#include "int8_decode.cuh"' in src
        assert "__global__" not in src
        assert list(_c_signatures(src)) == [entry]
        assert (build.CSRC / "int8_decode.cuh") in build._sources(
            build.CSRC / build.SOURCES[name], {})


class _Rec:
    """Stands in for one event of ``kineto_results.events()``."""

    def __init__(self, device, corr, name, ns=0):
        self._d, self._c, self._n, self._ns = device, corr, name, ns

    def start_ns(self):
        return 100 * self._c

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def name(self):
        return self._n

    def duration_ns(self):
        return self._ns


@pytest.mark.parametrize("lead_kept", [True, False])
def test_timed_records_count_only_the_calls_after_the_first_sync(lead_kept):
    """chip_smoke's device timing counts the records launched after the
    session's first ``cudaDeviceSynchronize`` (by correlation id), so the
    lead call's records, kept or dropped by the profiler, never change the
    sum, the count or the span, and a stream synchronize inside a call is
    no boundary; a session without the synchronize yields nothing (and is
    run again)."""
    from chip_smoke import timed_records
    ev = [_Rec("cpu", 1, "cudaLaunchKernel")]
    if lead_kept:
        ev.append(_Rec("cuda", 1, "k", 999))
    ev += [_Rec("cpu", 2, "cudaStreamSynchronize"),
           _Rec("cpu", 3, "cudaDeviceSynchronize")]
    for i, c in enumerate((4, 7, 10)):
        ev += [_Rec("cpu", c, "cudaLaunchKernel"),
               _Rec("cuda", c, "k", 10 + i),
               _Rec("cpu", c + 1, "cudaMemcpyAsync"),
               _Rec("cuda", c + 1, "Memcpy HtoD", 4),
               _Rec("cpu", c + 2, "cudaStreamSynchronize")]
    ev.append(_Rec("cpu", 13, "cudaDeviceSynchronize"))
    # the span: from the first timed record's start (corr 4) to the last
    # one's end (corr 11: start 1100, 4 ns)
    assert timed_records(ev, "cuda") == (
        {"k": (33, 3), "Memcpy HtoD": (12, 3)}, 1104 - 400)
    assert timed_records([e for e in ev
                          if e.name() != "cudaDeviceSynchronize"],
                         "cuda") == ({}, 0)


# ---------------- the ctypes bindings against the C sources ----------------

_C_KINDS = {"void*": "pointer", "int": "int", "int64_t": "int64",
            "float": "float"}


def _c_signatures(source: str) -> dict:
    """{name: [kind, ...]} of every ``extern "C"`` function in a CUDA
    source, each parameter reduced to pointer / int / int64 / float."""
    import re
    sigs = {}
    for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{',
                                   source, flags=re.S):
        kinds = []
        for p in params.split(","):
            words = p.replace("const ", "").split()
            kinds.append(_C_KINDS["void*" if "*" in p else words[0]])
        sigs[name] = kinds
    return sigs


class _FakeLibrary:
    """Stands in for a loaded kernel library: records the ``argtypes`` a
    wrapper sets on each function."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.fns.setdefault(name, type("Fn", (), {})())


@pytest.mark.parametrize("module", ["segmented_lora", "decode_attention",
                                    "decode_attention_int8",
                                    "paged_decode_attention",
                                    "paged_verify_attention",
                                    "flash_attention", "rmsnorm"])
def test_ctypes_argtypes_match_the_c_signatures(module, monkeypatch):
    """Each wrapper's ``argtypes`` have the count and kinds (pointer, int,
    int64, float) of its kernel's ``extern "C"`` entry point, so ctypes
    never passes a pointer as a 32-bit int or shifts an argument."""
    import ctypes
    import importlib

    from repro_torch.kernels import build
    kinds = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
             ctypes.c_int64: "int64", ctypes.c_float: "float"}
    fake = _FakeLibrary()
    monkeypatch.setattr(build, "load", lambda name: fake)
    importlib.import_module(f"repro_torch.kernels.{module}")._lib()
    sigs = _c_signatures((build.CSRC / build.SOURCES[module]).read_text())
    assert sigs and set(fake.fns) == set(sigs)
    for name, want in sigs.items():
        got = [kinds[t] for t in fake.fns[name].argtypes]
        assert got == want, name
        assert fake.fns[name].restype is ctypes.c_int
