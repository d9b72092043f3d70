"""Captured executables, one per shape key: the port's counterpart of
``jax.jit`` for the serving caches of ``PhysicalFM`` and ``DecodeEngine``.

The JAX package keeps a cache of compiled executables keyed by shape (the
bucketed jit caches of ``core/physical.py`` and ``core/decode_engine.py``);
each call of a cached function dispatches one executable. An eager PyTorch
closure instead dispatches every op of the model from Python, one kernel at
a time, so the host, not the card, sets the step time. ``Executable`` wraps
one closure of one shape key and runs it as one ``torch.cuda.CUDAGraph``:

  * **call 1 runs the closure eagerly**: real work with real effects, which
    also warms lazy state (cuBLAS handles, kernel libraries, shared-memory
    opt-ins, the SGMV kernel's workspace);
  * **call 2 captures, then replays once**: the tensor operands are copied
    into static buffers, the closure is captured on them (capture executes
    nothing, so a key first met while streams are live never writes their
    state twice), and one replay does the call's work;
  * **calls 3 and later** copy the operands into the static buffers and
    replay.

Operands. Positional arguments listed in ``bake`` are *baked*: their
tensors (nested in lists and dicts) are read and written where they lie at
capture, never copied (the weights, the KV pool, the adapter stack). Every
call checks that each baked tensor is still the same storage (data
pointer, shape, strides, dtype), and raises otherwise: a graph never
replays against freed or replaced memory. Every other tensor is *staged*
(tokens, lengths, page ids, segment metadata, embeddings): copied into the
key's static buffer, so its shape and dtype are part of the key. A
non-tensor argument (an int, a bool, None, a string) is part of the key
too, and a call whose value differs from call 1's raises. A
``torch.Generator`` passes through untouched: a captured closure must not
draw from it (the engines keep their sampling keys eager).

Outputs belong to the executable: a replay overwrites the previous call's
output tensors, so a caller copies out or consumes what must outlive the
next call. An output that is one of the arguments (the pool a write
returns) comes back as the caller's own object. Each graph has its own
memory pool.

Kernel launches are counted in Python where a wrapper launches
(``kernels.build.LAUNCHES``), which a replay never reaches: the launches of
the capture are recorded and added on every replay, so the counts stay
true.

On the CPU (the tests) nothing is captured, but calls 2 and later take the
same path: copy into the static buffers, run the closure on them, apply
the key and storage checks and the launch accounting, and copy the results
into the outputs of call 2. So a baked operand whose storage moved, a
Python value baked at capture or an output held across a later call fails
a CPU test as it would fail on the card.

``disabled()`` is the counterpart of ``jax.disable_jit()``: inside it every
executable runs its closure eagerly on every call, without checks.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

from repro_torch.kernels import build

_DISABLED = 0
_TENSOR, _GEN = object(), object()
_CONSTS = (type(None), bool, int, float, str)


@contextlib.contextmanager
def disabled():
    """Run every ``Executable`` eagerly inside this block (debugging, and
    the eager side of a graphed-against-eager comparison)."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1


def _flatten(x, tensors: list, gens: list):
    """The structure of ``x`` (lists, tuples, dicts, constants) with its
    tensors appended to ``tensors`` and its generators to ``gens``."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return _TENSOR
    if isinstance(x, (list, tuple)):
        return (type(x), tuple(_flatten(e, tensors, gens) for e in x))
    if isinstance(x, dict):
        return (dict, tuple(x), tuple(_flatten(v, tensors, gens)
                                      for v in x.values()))
    if isinstance(x, torch.Generator):
        gens.append(x)
        return _GEN
    if not isinstance(x, _CONSTS):
        raise TypeError(f"an executable's argument must be a tensor, a "
                        f"list/tuple/dict of them or a constant, not "
                        f"{type(x).__name__}")
    return (None, x)


def _unflatten(spec, tensors, gens):
    if spec is _TENSOR:
        return next(tensors)
    if spec is _GEN:
        return next(gens)
    kind = spec[0]
    if kind is dict:
        return {k: _unflatten(s, tensors, gens)
                for k, s in zip(spec[1], spec[2])}
    if kind is None:
        return spec[1]
    return kind(_unflatten(s, tensors, gens) for s in spec[1])


def _identity(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def _copy_into(dst: list, src: list):
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


class Executable:
    """One closure of one shape key, captured as a CUDA graph at its second
    call (module docstring). ``bake``: the positions of the arguments whose
    tensors are read in place; ``capture=False`` keeps the closure eager
    on every call (a sampling key, which draws from per-slot generators).
    ``launches`` holds the kernel launches of one call (recorded at
    capture) and ``capture_s`` the capture's host seconds."""

    def __init__(self, fn: Callable, *, bake=(), capture: bool = True):
        self.fn = fn
        self.bake = frozenset(bake)
        self.capture = capture
        self.calls = 0
        self.graph = None
        self.launches: dict = {}
        self.capture_s = None
        self._sig = None
        self._specs = None
        self._static = None
        self._out = None
        self._alias = self._alias_of = None
        self._cuda = None          # None until a capture succeeded

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def _split(self, args):
        specs, staged, baked, gens = [], [], [], []
        for i, a in enumerate(args):
            specs.append(_flatten(a, baked if i in self.bake else staged,
                                  gens))
        return tuple(specs), staged, baked, gens

    def __call__(self, *args):
        if _DISABLED or not self.capture:
            return self.fn(*args)
        specs, staged, baked, gens = self._split(args)
        sig = (specs, tuple((tuple(t.shape), t.dtype, t.device)
                            for t in staged),
               tuple(_identity(t) for t in baked))
        if self.calls == 0:
            self.calls = 1
            self._sig = sig
            return self.fn(*args)
        if sig != self._sig:
            self._mismatch(sig)
        self.calls += 1
        if self.calls == 2:
            return self._capture(args, specs, staged, baked, gens)
        if self._cuda is None:
            raise RuntimeError("this executable's capture failed")
        return self._replay(args, staged, gens)

    def _mismatch(self, sig):
        what = ("a non-tensor argument or the arguments' structure",
                "a staged tensor's shape, dtype or device",
                "a baked tensor's storage (data pointer, shape or strides)")
        part = next(i for i in range(3) if sig[i] != self._sig[i])
        raise ValueError(f"executable called with {what[part]} other than "
                         f"at its first call: that is another shape key, "
                         f"or a graph would replay against stale memory")

    def _static_args(self, args, gens):
        """The closure's arguments: baked ones as given, staged ones
        rebuilt over the static buffers (generators as given)."""
        tensors, gi = iter(self._static), iter(gens)
        return [a if i in self.bake else _unflatten(s, tensors, gi)
                for i, (a, s) in enumerate(zip(args, self._specs))]

    def _result(self, args):
        if self._alias == "arg":
            return args[self._alias_of]
        if self._alias is None:
            return self._out
        return type(self._out)(args[j] if j is not None else o
                               for o, j in zip(self._out, self._alias))

    def _record_out(self, out, static_args):
        """Keep the outputs; note which of them are arguments (returned as
        the caller's own objects on every later call)."""
        self._out = out

        def arg_of(o):
            return next((j for j, a in enumerate(static_args) if o is a),
                        None)
        j = arg_of(out)
        if j is not None:
            self._alias, self._alias_of = "arg", j
        elif isinstance(out, (tuple, list)):
            self._alias = [arg_of(o) for o in out]
        else:
            self._alias = None

    def _own_outputs(self, out) -> list:
        """The output tensors this executable owns (not arguments)."""
        if self._alias == "arg":
            return []
        parts = [out] if self._alias is None else \
            [o for o, j in zip(out, self._alias) if j is None]
        leaves: list = []
        for p in parts:
            _flatten(p, leaves, [])
        return leaves

    def _capture(self, args, specs, staged, baked, gens):
        self._specs = specs
        self._static = [t.clone() for t in staged]
        static_args = self._static_args(args, gens)
        before = dict(build.LAUNCHES)
        if any(t.is_cuda for t in staged + baked):
            g = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            with torch.cuda.graph(g):
                out = self.fn(*static_args)
            self.capture_s = time.perf_counter() - t0
            self.launches = _delta(before)
            for k, n in self.launches.items():      # nothing ran: undo
                build.LAUNCHES[k] -= n
            self.graph, self._cuda = g, True
            self._record_out(out, static_args)
            g.replay()
            _add(self.launches)
        else:
            t0 = time.perf_counter()
            out = self.fn(*static_args)
            self.capture_s = time.perf_counter() - t0
            self.launches = _delta(before)
            self._cuda = False
            self._record_out(out, static_args)
        return self._result(args)

    def _replay(self, args, staged, gens):
        _copy_into(self._static, staged)
        if self._cuda:
            self.graph.replay()
            _add(self.launches)
            return self._result(args)
        # the CPU: the closure on the static buffers, counted as a replay,
        # its results written into call 2's outputs
        static_args = self._static_args(args, gens)
        before = dict(build.LAUNCHES)
        out = self.fn(*static_args)
        build.LAUNCHES.clear()
        build.LAUNCHES.update(before)
        _add(self.launches)
        mine, new = self._own_outputs(self._out), self._own_outputs(out)
        if len(mine) != len(new) or any(
                m.shape != n.shape or m.dtype != n.dtype
                for m, n in zip(mine, new)):
            raise RuntimeError("an executable's outputs changed shape "
                               "between calls")
        _copy_into(mine, new)
        return self._result(args)


def _delta(before: dict) -> dict:
    return {k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()
            if n != before.get(k, 0)}


def _add(launches: dict):
    for k, n in launches.items():
        build.LAUNCHES[k] += n
