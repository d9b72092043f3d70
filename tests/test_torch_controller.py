"""The port's controller (Max-Share, elastic adaptation) and discrete-event
simulator against the JAX package's: the seven scenarios of
``tests/test_controller.py`` and the seven of ``tests/test_simulator.py``,
each run through both packages from the same inputs. Both are host code
over the same core modules (``core.profile``, ``core.bfq``,
``core.request``, ``core.vfm``), so the results must be EQUAL: the same
plans, cluster states and adaptation results, the same finished requests
with the same finish times (no tolerance). The JAX test's own claim is
checked on the port's result too.

Deployment ids come from a module counter in each package
(``controller.state._dep_ids``); each scenario restarts both at 0, so the
ids compare as they are. Request ids come from each package's own counter:
the finished lists are compared by (task, arrival, finish time) in order,
and the ids by their offsets from the trace's first."""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

import repro.controller as jctl  # noqa: E402
import repro.controller.state as jstate  # noqa: E402
import repro.core.profile as jprofile  # noqa: E402
import repro.serving.loadgen as jload  # noqa: E402
import repro.serving.metrics as jmetrics  # noqa: E402
import repro.serving.simulator as jsim  # noqa: E402
import repro_torch.controller as tctl  # noqa: E402
import repro_torch.controller.state as tstate  # noqa: E402
import repro_torch.core.profile as tprofile  # noqa: E402
import repro_torch.serving.loadgen as tload  # noqa: E402
import repro_torch.serving.metrics as tmetrics  # noqa: E402
import repro_torch.serving.simulator as tsim  # noqa: E402

JAX = dict(ctl=jctl, state=jstate, profile=jprofile, load=jload,
           metrics=jmetrics, sim=jsim)
PORT = dict(ctl=tctl, state=tstate, profile=tprofile, load=tload,
            metrics=tmetrics, sim=tsim)


@pytest.fixture(autouse=True)
def _fresh_dep_ids(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(pkg["state"], "_dep_ids", itertools.count())


def as_data(x):
    """Dataclasses (the packages' own classes) as plain dicts and lists."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: as_data(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: as_data(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [as_data(v) for v in x]
    return x


def cluster_data(c):
    return {"deployments": {k: {"server": d.server_id, "backbone": d.backbone,
                                "tasks": d.tasks, "routing": d.routing,
                                "partitions": d.partitions}
                            for k, d in c.deployments.items()},
            "bindings": c.task_bindings,
            "servers": {k: (s.alive, [d.dep_id for d in s.deployments])
                        for k, s in c.servers.items()}}


def cluster(pkg, n=4, mem=16e9, profiles=None):
    ctl = pkg["ctl"]
    profiles = profiles or {"moment-large": ctl.get_profile("moment-large")}
    return ctl.ClusterState([ctl.Server(f"s{i}", mem_bytes=mem)
                             for i in range(n)], profiles)


def cap_rps(pkg):
    cap = pkg["ctl"].get_profile("moment-large")
    return 0.8 * cap.b_max / cap.l(cap.b_max)


# ---------------- tests/test_controller.py, both packages ----------------

def ctl_prefers_existing_backbone(pkg):
    ctl = pkg["ctl"]
    c = cluster(pkg)
    ms = ctl.MaxShare(c)
    p1 = ms.place(ctl.TaskSpec("t0", "moment-large", demand_rps=5))
    p2 = ms.place(ctl.TaskSpec("t1", "moment-large", demand_rps=5))
    assert p1.new_deployments and not p2.new_deployments
    return [as_data(p1), as_data(p2), cluster_data(c)]


def ctl_provisions_when_capacity_exhausted(pkg):
    ctl = pkg["ctl"]
    c = cluster(pkg)
    ms = ctl.MaxShare(c)
    p1 = ms.place(ctl.TaskSpec("big", "moment-large",
                               demand_rps=cap_rps(pkg) * 0.9))
    plan = ms.place(ctl.TaskSpec("t1", "moment-large",
                                 demand_rps=cap_rps(pkg) * 0.5))
    assert plan is not None and plan.new_deployments
    return [as_data(p1), as_data(plan), cluster_data(c)]


def ctl_replication_splits_demand(pkg):
    ctl = pkg["ctl"]
    c = cluster(pkg)
    plan = ctl.MaxShare(c).place(ctl.TaskSpec(
        "huge", "moment-large", demand_rps=cap_rps(pkg) * 2.5))
    assert plan is not None and len(plan.assignment) >= 3
    assert sum(plan.assignment.values()) == pytest.approx(1.0)
    return [as_data(plan), cluster_data(c)]


def ctl_infeasible_returns_none_and_rolls_back(pkg):
    prof = pkg["profile"].FMProfile("big-fm", memory_bytes=int(20e9))
    c = cluster(pkg, profiles={"big-fm": prof})
    plan = pkg["ctl"].MaxShare(c).place(pkg["ctl"].TaskSpec("t", "big-fm"))
    assert plan is None and not c.deployments
    return [plan, cluster_data(c)]


def ctl_memory_admission_limits_instance_per_task(pkg):
    ctl = pkg["ctl"]
    prof = ctl.get_profile("moment-large")
    c = cluster(pkg, n=1)
    ms = ctl.MaxShare(c)
    plans = [ms.place(ctl.TaskSpec(f"t{i}", "moment-large", demand_rps=1.0))
             for i in range(60)]
    admitted = sum(1 for p in plans if p)
    assert admitted >= 6 * int(16e9 // prof.memory_bytes)
    return [as_data(plans), cluster_data(c)]


def ctl_adaptation_rebind_is_fast_path(pkg):
    ctl = pkg["ctl"]
    c = cluster(pkg)
    ms = ctl.MaxShare(c)
    for i in range(3):
        ms.place(ctl.TaskSpec(f"t{i}", "moment-large", demand_rps=5))
    ea = ctl.ElasticAdapter(c)
    res = ea.on_surge(ctl.TaskSpec("t0", "moment-large", demand_rps=5), 10.0)
    assert res.path == "rebind" and res.ready_s < 0.1
    res2 = ea.on_surge(ctl.TaskSpec("t1", "moment-large", demand_rps=5),
                       500.0)
    assert res2.path in ("provision", "infeasible")
    return [as_data(res), as_data(res2), cluster_data(c)]


def ctl_failure_rebinds_all_tasks(pkg):
    ctl = pkg["ctl"]
    c = cluster(pkg)
    ms = ctl.MaxShare(c)
    for i in range(6):
        ms.place(ctl.TaskSpec(f"t{i}", "moment-large", demand_rps=5))
    ea = ctl.ElasticAdapter(c)
    dead = [d.server_id for d in c.deployments.values()][0]
    results = ea.on_server_failure(dead)
    assert results and all(r.path in ("rebind", "provision")
                           for r in results)
    for t in [f"t{i}" for i in range(6)]:
        assert all(c.deployments[d].server_id != dead
                   for d in c.task_bindings[t])
    return [as_data(results), cluster_data(c)]


@pytest.mark.parametrize("scenario", [
    ctl_prefers_existing_backbone, ctl_provisions_when_capacity_exhausted,
    ctl_replication_splits_demand, ctl_infeasible_returns_none_and_rolls_back,
    ctl_memory_admission_limits_instance_per_task,
    ctl_adaptation_rebind_is_fast_path, ctl_failure_rebinds_all_tasks],
    ids=lambda f: f.__name__)
def test_controller_equals_jax(scenario):
    """Plans, cluster state and adaptation results equal between the
    packages (the claim of the JAX test holds on each)."""
    assert scenario(PORT) == scenario(JAX)


def test_paper_profiles_are_the_papers():
    """``PAPER_PROFILES`` is the JAX package's table, unchanged."""
    assert {k: as_data(v) for k, v in tctl.PAPER_PROFILES.items()} == \
        {k: as_data(v) for k, v in jctl.PAPER_PROFILES.items()}


# ---------------- tests/test_simulator.py, both packages ----------------

def prof(pkg):
    return pkg["profile"].FMProfile(
        "fm", alpha=16.8e-3, beta=9.5e-3, b_max=16,
        memory_bytes=int(1.5e9), task_memory_bytes=int(1e6),
        adapter_alpha=2e-3, adapter_beta=4e-4)


def run(pkg, mode, tasks, arrivals, horizon):
    sim, ok = pkg["sim"].build_single_gpu(mode, tasks, prof(pkg))
    assert ok
    return sim.run(arrivals, horizon)


def finished(fin, rid0):
    return [(r.task_id, r.rid - rid0, r.arrival, r.finish_time) for r in fin]


def pair_trace(pkg, rate, seconds):
    load = pkg["load"]
    return load.merge([load.poisson_trace("A", rate, seconds, seed=1),
                       load.poisson_trace("B", rate, seconds, seed=2)])


def sim_underload_everything_completes(pkg):
    arr = pair_trace(pkg, 5, 10)
    rid0 = min(r.rid for r in arr)
    fin = run(pkg, "fmplex", [{"task_id": "A"}, {"task_id": "B"}], arr, 60.0)
    assert len(fin) == len(arr) and all(r.finish_time is not None
                                        for r in fin)
    return finished(fin, rid0)


def sim_batching_beats_serial_at_load(pkg):
    tasks = [{"task_id": "A"}, {"task_id": "B"}]
    arr = pair_trace(pkg, 40, 10)
    rid0 = min(r.rid for r in arr)
    lat = pkg["metrics"].latency_stats
    # as in the JAX test, both runs take the same request objects
    f1 = run(pkg, "fmplex", tasks, list(arr), 200.0)
    out, l1 = finished(f1, rid0), lat(f1)
    f2 = run(pkg, "s-stfq", tasks, list(arr), 200.0)
    assert l1["mean_ms"] < lat(f2)["mean_ms"] / 3
    return [out, l1, finished(f2, rid0)]


def sim_sp_partition_inflates_latency_at_low_load(pkg):
    tasks = [{"task_id": "A"}, {"task_id": "B"}]
    lat = pkg["metrics"].latency_stats
    a = lat(run(pkg, "fmplex", tasks, pair_trace(pkg, 1, 10), 60.0))
    b = lat(run(pkg, "sp", tasks, pair_trace(pkg, 1, 10), 60.0))
    assert b["mean_ms"] > a["mean_ms"] * 1.1
    return [a, b]


def sim_be_processor_sharing_slows_under_contention(pkg):
    tasks = [{"task_id": "A"}, {"task_id": "B"}]
    lat = pkg["metrics"].latency_stats
    a = lat(run(pkg, "fmplex", tasks, pair_trace(pkg, 20, 10), 120.0))
    b = lat(run(pkg, "be", tasks, pair_trace(pkg, 20, 10), 120.0))
    assert b["mean_ms"] > a["mean_ms"]
    return [a, b]


def sim_fairness_separates_at_saturation(pkg):
    tasks = [{"task_id": "A", "weight": 3.0}, {"task_id": "B", "weight": 1.0}]
    w = {"A": 3.0, "B": 1.0}

    def shares(mode):
        fin = run(pkg, mode, tasks, pair_trace(pkg, 100, 20), 21.0)
        done = [r for r in fin
                if r.finish_time is not None and r.finish_time < 20]
        return {t: sum(1 for r in done if r.task_id == t) for t in w}
    s_bfq, s_sbe = shares("fmplex"), shares("s-be")
    jain = pkg["metrics"].jain_fairness
    assert jain(s_bfq, w) > 0.95 and jain(s_bfq, w) > jain(s_sbe, w) + 0.05
    return [s_bfq, s_sbe]


def sim_noisy_neighbor_isolation(pkg):
    tasks = [{"task_id": "A", "weight": 3.0}, {"task_id": "B", "weight": 1.0}]
    load = pkg["load"]

    def b_thr(mode):
        arr = load.merge([load.burst_trace("A", 5, 500, burst_start=10,
                                           burst_len=10, horizon=30, seed=1),
                          load.poisson_trace("B", 60, 30, seed=2)])
        rid0 = min(r.rid for r in arr)
        fin = run(pkg, mode, tasks, arr, 60.0)
        thr = sum(1 for r in fin if r.task_id == "B" and r.finish_time
                  and 10 <= r.finish_time < 20) / 10.0
        return thr, finished(fin, rid0)
    (t_bfq, f_bfq), (t_sbe, f_sbe) = b_thr("fmplex"), b_thr("s-be")
    assert t_bfq > 20 and t_bfq > t_sbe * 1.5
    return [t_bfq, t_sbe, f_bfq, f_sbe]


def sim_memory_admission_matches_paper_oom(pkg):
    p = pkg["ctl"].get_profile("moment-large")
    tasks = [{"task_id": f"t{i}"} for i in range(10)]
    _, ok_shared = pkg["sim"].build_single_gpu("fmplex", tasks, p)
    _, ok_be = pkg["sim"].build_single_gpu("be", tasks, p)
    assert ok_shared and not ok_be
    return [ok_shared, ok_be]


@pytest.mark.parametrize("scenario", [
    sim_underload_everything_completes, sim_batching_beats_serial_at_load,
    sim_sp_partition_inflates_latency_at_low_load,
    sim_be_processor_sharing_slows_under_contention,
    sim_fairness_separates_at_saturation, sim_noisy_neighbor_isolation,
    sim_memory_admission_matches_paper_oom], ids=lambda f: f.__name__)
def test_simulator_equals_jax(scenario):
    """The same finished requests and finish times (or latency stats and
    shares) from the same traces in both packages."""
    assert scenario(PORT) == scenario(JAX)
