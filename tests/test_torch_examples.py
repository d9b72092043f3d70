"""The port's examples at smoke size on the CPU, each held against its JAX
twin where the two compute the same thing: ``examples/cluster_sim_torch.py``
(host work only) gives the placement, surge and recovery of
``examples/cluster_sim.py``; ``examples/quickstart_torch.py`` fine-tunes
reduced moment-large with ``--device cpu --reduced`` (its loss must fall)
and packages the task; ``examples/train_e2e_torch.py`` trains reduced
xlstm-125m through ``repro_torch.launch.train`` with ``--device cpu``
(the failure fires, the run restores and finishes, the loss falls);
``examples/serve_multitask_torch.py`` serves its pooled and mixed paged
planes with ``--device cpu --reduced``."""
import importlib.util
import itertools
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cluster_sim_torch_matches_the_jax_example(monkeypatch, capsys):
    import repro.controller.state as jstate
    import repro_torch.controller.state as tstate
    for st in (jstate, tstate):
        monkeypatch.setattr(st, "_dep_ids", itertools.count())
    got = _load("cluster_sim_torch").main()
    port_out = capsys.readouterr().out
    _load("cluster_sim").main()
    assert port_out == capsys.readouterr().out
    assert got["placed"] == 60 and got["recovered"] > 0
    assert got["surge"] in ("rebind", "provision")


def test_quickstart_torch_on_the_cpu(capsys):
    losses = _load("quickstart_torch").main(
        ["--device", "cpu", "--reduced", "--steps", "30"])
    out = capsys.readouterr().out
    assert len(losses) == 30 and min(losses[-10:]) < losses[0]
    assert "artifact:" in out and "'task_id': 'heart_rate'" in out


def test_train_e2e_torch_on_the_cpu(capsys):
    losses, inj = _load("train_e2e_torch").main(
        ["--device", "cpu", "--steps", "30", "--fail-at", "12", "--batch",
         "4", "--seq", "32"])
    out = capsys.readouterr().out
    assert inj.fired and len(losses) >= 30
    assert np.mean(losses[-5:]) < losses[0]
    assert "restored step 10" in out and "restarted=True" in out


def test_serve_multitask_torch_pooled_on_the_cpu(capsys):
    """``examples/serve_multitask_torch.py --device cpu --reduced``: the
    pooled plane under each scheduler (reduced moment-large, as the JAX
    twin serves it) serves requests."""
    got = _load("serve_multitask_torch").main(
        ["--device", "cpu", "--reduced", "--tasks", "2", "--rps", "20",
         "--seconds", "0.5"])
    assert set(got) == {"bfq", "stfq", "s-be"}
    assert all(s["n"] > 0 for s in got.values())
    assert "fairness=" in capsys.readouterr().out


def test_serve_multitask_torch_mixed_paged_on_the_cpu(capsys):
    """``--mixed --paged``: pooled and generative traffic through one
    ``ServeLoop`` on the paged pool (reduced stablelm-1.6b); both planes
    serve and the page gauges print."""
    s = _load("serve_multitask_torch").main(
        ["--device", "cpu", "--reduced", "--mixed", "--paged", "--tasks",
         "4", "--rps", "20", "--seconds", "1"])
    assert s["pooled"].get("n", 0) > 0 and s["decode"].get("n", 0) > 0
    out = capsys.readouterr().out
    assert "mixed:" in out and "kv pages:" in out
