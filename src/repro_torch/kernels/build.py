"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). Libraries land in ``build/kernels/`` at the
repository root, named by a hash of the source, the headers it includes and
the flags, on first use;
``build_all`` starts one ``nvcc`` per source at once. Nothing here runs when
the module is imported.

Launch counts live here too (``LAUNCHES``, re-exported as
``kernels.ops.LAUNCHES``): each kernel wrapper adds one where it launches its
kernel, so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

SOURCES = {
    "segmented_lora": "segmented_lora.cu",
    "decode_attention_int8": "decode_attention_int8.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
    "paged_verify_attention": "paged_verify_attention.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
    "decode_attention": "decode_attention.cu",
    "rmsnorm": "rmsnorm.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

LAUNCHES: collections.Counter = collections.Counter()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches():
    """Set every launch count to 0 (in place: callers hold the object)."""
    for k in list(LAUNCHES):
        LAUNCHES[k] = 0


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the GPU (set CUDA_HOME)")
    return str(path)


def _sources(path: Path, seen: dict) -> dict:
    """``path`` and every file it includes by a quoted ``#include`` found
    beside the includer, recursively: {path: bytes}, in the order met."""
    if path in seen or not path.exists():
        return seen
    text = seen[path] = path.read_bytes()
    for inc in re.findall(rb'^\s*#\s*include\s+"([^"]+)"', text, flags=re.M):
        _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    """Where kernel ``name``'s library lives: named by a hash of its source,
    of every header it includes from ``csrc/`` and of the flags, so that an
    edit to a shared header rebuilds every library that includes it."""
    h = hashlib.sha256()
    for path, text in _sources(CSRC / SOURCES[name], {}).items():
        h.update(path.name.encode() + b"\0" + text + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, all started together. The ptxas report
    (registers, shared memory, spills) is kept beside each library as
    ``<name>.log``. Raises with the compiler output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = {}
    for n, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    errors = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        (BUILD_DIR / f"{n}.log").write_text(log)
        if p.returncode != 0:
            errors.append(f"{n}: nvcc exited {p.returncode}\n{log}")
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index`` (the wrappers size their
    key splits by it, ``key_splits``)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def current_stream(index: int) -> int:
    """The raw handle of PyTorch's current CUDA stream on device ``index``,
    for a launch. ``torch.cuda.current_stream(...).cuda_stream`` builds a
    Stream object on every call (several microseconds of host time on the
    launch path); PyTorch's own raw getter returns the handle alone."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def key_splits(ctas: int, keys: int, tile: int, min_split: int,
               sms: int, slots: int | None = None) -> tuple[int, int]:
    """(number of splits, keys per split) of a key axis of ``keys`` that
    ``ctas`` CTAs walk on ``sms`` SMs: enough splits for about two CTAs per
    SM, each split a multiple of ``tile`` and at least ``min_split`` keys.
    Where the CTAs are enough already, or there are fewer keys than two
    minimum splits (there the merge costs more than the split saves), one
    split holds every key. ``slots``, when given, is how many CTAs of the
    kernel the card holds at once: the splits then stop at as many as fit
    in one wave (``slots // ctas``). Shapes only, never lengths: choosing
    needs no host sync."""
    if keys < 2 * min_split:
        want = 1
    elif slots is None:
        want = -(-2 * sms // max(ctas, 1))
    else:
        want = max(1, slots // max(ctas, 1))
    n = max(1, min(want, -(-keys // min_split)))
    split_len = tile * max(1, -(-(-(-keys // n)) // tile))
    return max(1, -(-keys // split_len)), split_len


def check(err: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
