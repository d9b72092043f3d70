"""The port's fault-tolerant serving plane on its paged serve loop, case for
case with ``tests/test_faults.py``, on reduced stablelm-1.6b with the JAX
weights and adapters converted to the port: per-stream numeric quarantine
with exact co-batch token parity, the loop's quarantine stamp, deadline
enforcement (live cancel and pending shed), the infeasible-deadline shed,
client cancellation across request states, head-failure isolation, the
watchdog under an injected stall, page pressure, the stranded-sharer wedge,
and the chaos scheduler.

Where a case's outcome does not depend on the model's rounding (which
stream is quarantined, cancelled, shed or rejected, and how many tokens it
kept), the same script runs on the JAX engine and the terminal statuses
and token counts must be equal; the chaos scheduler's log must equal the
JAX scheduler's on the same events and ticks. Tokens of the port are held
against the port itself (exact), as JAX's test holds JAX against itself.
"""
import pytest

torch = pytest.importorskip("torch")

import time  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.core.decode_engine import DecodeEngine as JDecodeEngine  # noqa: E402
from repro.core.physical import PhysicalFM as JPhysicalFM  # noqa: E402
from repro.serving import faults as jfaults  # noqa: E402
from repro_torch import weights  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.decode_engine import DecodeEngine  # noqa: E402
from repro_torch.core.physical import PhysicalFM  # noqa: E402
from repro_torch.core.request import FAILURE_STATUSES, SLO, Request  # noqa: E402
from repro_torch.core.server import FMplexServer  # noqa: E402
from repro_torch.core.vfm import TaskExtensions  # noqa: E402
from repro_torch.serving import faults  # noqa: E402
from repro_torch.serving.faults import (NaNAdapterFault,  # noqa: E402
                                        PagePressureFault, RaisingHeadFault,
                                        StallFault)

ENGINE_KW = dict(num_slots=2, prompt_len=8, max_new=16, chunk=2, paged=True,
                 page_size=4)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads: the suite runs in parallel workers on shared
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fms():
    """The JAX FM and the port's on its weights, three fresh adapters each
    (``adapters.new(seed=i)``, the JAX trees converted)."""
    jcfg = jreduced(jget_config("stablelm-1.6b"))
    cfg = reduced(get_config("stablelm-1.6b"))
    jfm = JPhysicalFM(jcfg, seed=0, input_len=8, lora_rank=4)
    fm = PhysicalFM(cfg, seed=0, input_len=8, lora_rank=4, device="cpu",
                    params=weights.to_torch(jax.tree.map(np.asarray,
                                                         jfm.params),
                                            device="cpu"))
    for i in range(3):
        tree = jfm.adapters.new(f"lora{i}", seed=i)
        fm.adapters.add(f"lora{i}", weights.adapter_tree(
            jax.tree.map(np.asarray, tree), device="cpu"))
    return jfm, fm, cfg


@pytest.fixture(scope="module")
def served(fms):
    """One warmed server and PAGED loop shared by the module (the paged
    pool exposes the whole failure surface: pending queue, stranding,
    pages)."""
    _, fm, cfg = fms
    fm.calibrate(sizes=(1, 2, 4))
    srv = FMplexServer("s0")
    srv.deploy_fm("fm0", fm, scheduler="bfq")
    rng = np.random.RandomState(0)
    for i in range(3):
        w = rng.randn(cfg.d_model, 2).astype(np.float32) * 0.1
        head = (lambda ww: (lambda f: f @ ww))(w)
        srv.bind_task(f"task{i}", "fm0", weight=float(i + 1),
                      extensions=TaskExtensions(decoder=head,
                                                adapter_id=f"lora{i}"))
    loop = srv.serve_loop("fm0", engine_kwargs=dict(ENGINE_KW))
    loop.warmup(pooled_task="task0", gen_task="task1")
    return srv, cfg, loop, rng


def _shim(fm, eng=None):
    """What a fault sees of a loop: the server's FMs and the engine."""
    return types.SimpleNamespace(srv=types.SimpleNamespace(fms={"fm0": fm}),
                                 fm_id="fm0", _engine=lambda: eng)


def _pooled(cfg, rng, tid="task0", t=0.0):
    return Request(tid, t, payload=rng.randn(8, cfg.d_model).astype(np.float32))


def _gen(cfg, rng, tid="task1", t=0.0, new=6, plen=8):
    return Request(tid, t,
                   payload=rng.randint(0, cfg.vocab_size, plen).astype("int32"),
                   tokens=float(plen + new), max_new_tokens=new)


def _run_stream(eng, rid):
    """Step the engine until stream ``rid`` retires; return its slot."""
    for _ in range(64):
        for s in eng.step_chunk():
            if s.rid == rid:
                return s
    raise AssertionError(f"stream {rid} never retired")


# ---------------- numeric-fault quarantine ----------------

def _quarantine_script(eng, loop, fault_cls, cfg):
    """test_faults.py's script: a clean stream alone, then the same stream
    co-batched with one on a NaN'd adapter. Returns the solo tokens and the
    retired streams."""
    rng = np.random.RandomState(7)
    clean = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    bad = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    eng.join("task1", clean, adapter_id="lora1", max_new_tokens=6, rid=9001)
    solo = _run_stream(eng, 9001).tokens
    fault = fault_cls("lora0")
    fault.inject(loop)
    try:
        eng.join("task1", clean, adapter_id="lora1", max_new_tokens=6,
                 rid=9002)
        eng.join("task0", bad, adapter_id="lora0", max_new_tokens=6,
                 rid=9003)
        retired = {s.rid: s for s in eng.step_chunk()}
        for _ in range(32):
            if 9002 in retired and 9003 in retired:
                break
            retired.update({s.rid: s for s in eng.step_chunk()})
    finally:
        fault.restore(loop)
    return solo, retired, bad


def test_quarantine_isolates_poisoned_stream_with_exact_parity(served, fms):
    """A NaN'd adapter (swapped tree, the stack slot rewritten in place)
    quarantines ONLY its own stream, at admission, before any page or
    prefix registration, while the co-batched clean stream's tokens match
    its solo run bit for bit, with no new shape key and the adapter stack
    never moved; the JAX engine gives the same statuses and counts."""
    srv, cfg, loop, _ = served
    jfm, fm, _ = fms
    eng = srv.engines["fm0"]
    stack = fm.adapters.stacked()
    ptrs = [t.data_ptr() for t in _leaves(stack)]
    q0, keys, free0 = eng.quarantines, eng.compile_count(), \
        eng.free_page_count()
    solo, retired, bad = _quarantine_script(eng, loop, NaNAdapterFault, cfg)
    assert retired[9003].status == "quarantined"
    assert eng.quarantines == q0 + 1
    assert len(retired[9003].tokens) == 1
    assert eng._match_prefix("lora0", bad) == []
    assert retired[9002].status == "ok" and retired[9002].tokens == solo
    assert eng.compile_count() == keys
    assert [t.data_ptr() for t in _leaves(fm.adapters.stacked())] == ptrs
    assert all(torch.isfinite(t).all() for t in _leaves(fm.adapters.stacked()))
    assert not eng.active_count() and eng.free_page_count() == free0
    eng.take_admitted()
    jeng = JDecodeEngine(jfm, **ENGINE_KW)
    jsolo, jretired, _ = _quarantine_script(jeng, _shim(jfm, jeng),
                                            jfaults.NaNAdapterFault, cfg)
    assert len(jsolo) == len(solo)
    assert {r: (s.status, len(s.tokens)) for r, s in jretired.items()} == \
        {r: (s.status, len(s.tokens)) for r, s in retired.items()}
    # the restored adapter serves cleanly again through the loop
    r = _gen(cfg, np.random.RandomState(8), tid="task0", new=4)
    loop.run([r], max_wall=60)
    assert r.ok and len(r.result) == 4


def _leaves(tree):
    from repro_torch.models.common import tree_leaves
    return tree_leaves(tree)


def test_loop_stamps_quarantined_status(served):
    srv, cfg, loop, _ = served
    fail0 = loop.failures["quarantined"]
    fault = NaNAdapterFault("lora2")
    fault.inject(loop)
    try:
        r = _gen(cfg, np.random.RandomState(11), tid="task2", new=4)
        loop.run([r], max_wall=60)
    finally:
        fault.restore(loop)
    assert r.status == "quarantined" and not r.ok
    assert r.error and not r.met_deadline()
    assert loop.failures["quarantined"] == fail0 + 1


# ---------------- deadline enforcement ----------------

def _deadline_script(eng, cfg):
    """test_faults.py's script: a live stream past its deadline, then an
    expired join deferred behind two live ones. Returns (the cancelled
    stream's status and token count, the rejections, the admitted rids)."""
    eng.take_admitted()
    rng = np.random.RandomState(13)
    p = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    eng.join("task1", p, adapter_id="lora1", max_new_tokens=8, rid=9101,
             deadline=time.perf_counter() - 1.0)
    s = _run_stream(eng, 9101)
    for rid in (9102, 9103):
        eng.join("task1", rng.randint(0, cfg.vocab_size, 8).astype(np.int32),
                 adapter_id="lora1", max_new_tokens=16, rid=rid)
    admitted = {rid for rid, *_ in eng.take_admitted()}
    eng.join("task2", rng.randint(0, cfg.vocab_size, 8).astype(np.int32),
             adapter_id="lora2", max_new_tokens=16, rid=9104,
             deadline=time.perf_counter() - 1.0)
    pending = eng.pending_count()
    eng.step_chunk()
    rej = [(p.rid, p.status) for p in eng.take_rejected()]
    admitted |= {rid for rid, *_ in eng.take_admitted()}
    for rid in (9102, 9103):
        assert eng.cancel(rid) is not None
    eng.take_admitted()
    return (s.status, len(s.tokens)), pending, rej, admitted


def test_deadline_cancels_live_and_sheds_pending(served, fms):
    """A live slot past its deadline retires with its partial tokens; an
    expired deferred join is shed terminally, never admitted (so never
    charged); the JAX engine gives the same statuses and counts."""
    srv, cfg, _, _ = served
    jfm, _, _ = fms
    eng = srv.engines["fm0"]
    c0, s0 = eng.deadline_cancels, eng.deadline_sheds
    live, pending, rej, admitted = _deadline_script(eng, cfg)
    assert live[0] == "deadline_cancelled" and 1 <= live[1] < 8
    assert eng.deadline_cancels == c0 + 1
    assert pending == 1 and rej == [(9104, "deadline_shed")]
    assert eng.deadline_sheds == s0 + 1
    assert 9104 not in admitted
    assert not eng.active_count() and not eng.pending_count()
    assert _deadline_script(JDecodeEngine(jfm, **ENGINE_KW), cfg) == \
        (live, pending, rej, admitted)


def test_loop_sheds_infeasible_deadline_before_prefill(served):
    """Queued requests whose predicted TTFT already busts the deadline are
    shed before admission with a tag refund; a follow-up still serves."""
    srv, cfg, loop, _ = served
    rng = np.random.RandomState(17)
    r = _gen(cfg, rng, tid="task1", new=8)
    r.slo = SLO(1e-6)                            # infeasible by construction
    shed0 = loop.failures["deadline_shed"]
    loop.run([r], max_wall=60)
    assert r.status == "deadline_shed" and r.result is None
    assert loop.failures["deadline_shed"] == shed0 + 1
    r2 = _gen(cfg, rng, tid="task1", new=4)
    loop.run([r2], max_wall=60)
    assert r2.ok and len(r2.result) == 4


# ---------------- client cancellation ----------------

def test_loop_cancel_unwinds_queued_and_live(served):
    srv, cfg, loop, _ = served
    eng = srv.engines["fm0"]
    sched = loop.sched
    rng = np.random.RandomState(19)
    r = _gen(cfg, rng, tid="task2", new=8)
    loop.submit(r, time.perf_counter())
    assert loop.cancel(r.rid)
    assert r.status == "cancelled" and r.finish_time is not None
    assert not any(v.queue for v in srv.vfms_on("fm0").values())
    assert sched._tail.get("task2", 0.0) == pytest.approx(
        sched._last_dispatched.get("task2", 0.0))
    assert not loop.cancel(r.rid)                # already terminal
    free0 = eng.free_page_count()
    r2 = _gen(cfg, rng, tid="task1", new=16)
    loop.submit(r2, time.perf_counter())
    while not eng.active_count():
        loop.tick()
    assert loop.cancel(r2.rid)
    assert r2.status == "cancelled"
    assert r2.result is not None and len(r2.result) >= 1
    assert r2.first_token_time is not None
    assert not eng.active_count() and eng.free_page_count() == free0
    assert not loop.cancel(10 ** 9)              # unknown rid
    while loop._work_left():
        loop.tick()


# ---------------- per-task head-failure isolation ----------------

def test_head_failure_isolates_task_and_recovers(served):
    srv, cfg, loop, _ = served
    ex = srv.executors["fm0"]
    rng = np.random.RandomState(23)
    hf0, retries0 = ex.head_failures["task2"], ex.retries
    fault = RaisingHeadFault("task2")
    fault.inject(loop)
    try:
        r_ok = _pooled(cfg, rng, tid="task0")
        r_bad = _pooled(cfg, rng, tid="task2")
        loop.run([r_ok, r_bad], max_wall=60)
    finally:
        fault.restore(loop)
    assert r_bad.status == "head_failed" and r_bad.result is None
    assert r_bad.error and "InjectedFailure" in r_bad.error
    assert r_ok.ok and np.all(np.isfinite(np.asarray(r_ok.result)))
    assert ex.head_failures["task2"] == hf0 + 1
    assert ex.retries == retries0 + ex.head_retries
    r_again = _pooled(cfg, rng, tid="task2")
    loop.run([r_again], max_wall=60)
    assert r_again.ok and np.all(np.isfinite(np.asarray(r_again.result)))


# ---------------- watchdog + stall ----------------

def test_watchdog_trips_on_stall_then_stream_recovers(served):
    srv, cfg, loop, _ = served
    eng = srv.engines["fm0"]
    rng = np.random.RandomState(29)
    old = loop.watchdog_stall_s
    loop.watchdog_stall_s = 0.05
    trips0 = loop.failures["watchdog_trips"]
    stream = _gen(cfg, rng, tid="task1", new=12)
    loop.submit(stream, time.perf_counter())
    while not eng.active_count():
        loop.tick()
    fault = StallFault()
    fault.inject(loop)
    t0 = time.perf_counter()
    try:
        while loop.failures["watchdog_trips"] == trips0:
            loop.tick()
            assert time.perf_counter() - t0 < 10.0, "watchdog never tripped"
    finally:
        fault.restore(loop)
        loop.watchdog_stall_s = old
    while stream.finish_time is None:
        loop.tick()
    assert stream.ok and len(stream.result) == 12
    while loop._work_left():
        loop.tick()


def test_page_pressure_fault_steals_and_returns(served):
    srv, cfg, loop, _ = served
    eng = srv.engines["fm0"]
    free0 = eng.free_page_count()
    assert free0 > 0
    fault = PagePressureFault(1.0)
    fault.inject(loop)
    try:
        assert eng.free_page_count() == 0
        assert not eng.can_admit(8)              # memory gate closed
    finally:
        fault.restore(loop)
    assert eng.free_page_count() == free0
    assert eng.can_admit(8)


# ---------------- stranded-sharer wedge recovery ----------------

def _stranded_script(eng, cfg):
    rng = np.random.RandomState(31)
    prefix = rng.randint(0, cfg.vocab_size, 8).astype(np.int32)
    slot_a = eng.join("t", prefix, adapter_id="lora0", max_new_tokens=4,
                      rid=1)
    sfx = rng.randint(0, cfg.vocab_size, 4).astype(np.int32)
    slot_b = eng.join("t", np.concatenate([prefix, sfx]), adapter_id="lora0",
                      max_new_tokens=4, rid=2)
    pending = eng.pending_count()
    assert eng.cancel(1) is not None
    with pytest.raises(ValueError, match="no longer fit"):
        eng.step_chunk()                         # wedged: loud for direct use
    shed = eng.shed_stranded()
    rej = [(p.rid, p.status) for p in eng.take_rejected()]
    return slot_a >= 0, slot_b, pending, shed, rej, eng.step_chunk()


def test_stranded_sharer_wedge_sheds_terminally(served, fms):
    """A deferred join admitted on a prefix discount whose sharer leaves is
    stranded; the engine raises its wedge for direct users and
    ``shed_stranded`` rejects it terminally; the JAX engine agrees."""
    jfm, fm, cfg = fms
    kw = dict(num_slots=2, prompt_len=16, max_new=4, chunk=2, paged=True,
              page_size=4, total_pages=5, prompt_buckets=(8, 16))
    eng = DecodeEngine(fm, **kw)
    got = _stranded_script(eng, cfg)
    assert got == (True, -1, 1, 1, [(2, "rejected_stranded")], [])
    assert "rejected_stranded" in FAILURE_STATUSES
    assert eng.free_page_count() == eng.total_pages - 1
    assert _stranded_script(JDecodeEngine(jfm, **kw), cfg) == got


# ---------------- chaos-injection scheduler ----------------

def test_chaos_injector_schedule_is_deterministic_and_matches_jax():
    """The same events and ticks through the port's scheduler and the JAX
    package's: the same transitions in the same order, and the same log."""
    logs, states = [], []
    for mod in (faults, jfaults):
        class Rec(mod.Fault):
            def __init__(self, name):
                self.name, self.state = name, "idle"

            def inject(self, loop):
                self.state = "armed"

            def restore(self, loop):
                self.state = "restored"

        f1, f2 = Rec("f1"), Rec("f2")
        inj = mod.ChaosInjector([mod.ChaosEvent(0.5, f2, duration=1.0),
                                 mod.ChaosEvent(0.0, f1)])
        seen = []
        for rel in (0.0, 0.6, 1.4, 1.6):
            inj.on_tick(None, rel)
            seen.append((f1.state, f2.state))
        inj.restore_all(None)
        seen.append((f1.state, f2.state))
        logs.append(inj.log)
        states.append(seen)
    assert states[0] == states[1] == [
        ("armed", "idle"), ("armed", "armed"), ("armed", "armed"),
        ("armed", "restored"), ("restored", "restored")]
    assert logs[0] == logs[1]
    assert [(n, a) for _, n, a in logs[0]] == [
        ("f1", "inject"), ("f2", "inject"), ("f2", "restore"),
        ("f1", "restore_all")]
