"""Cluster-scale scenario on the PyTorch port's controller: Max-Share
placement of 60 tasks over 8 servers, a demand surge handled by vFM
rebinding, and a server failure handled by Controller-driven recovery (host
work: the planning plane needs no card).

  PYTHONPATH=src python examples/cluster_sim_torch.py
"""
from repro_torch.controller import (ClusterState, ElasticAdapter, MaxShare,
                                    Server, TaskSpec)
from repro_torch.controller.profiles import get_profile


def main() -> dict:
    profiles = {b: get_profile(b) for b in
                ("moment-large", "dinov2-base", "qwen2.5-3b")}
    cluster = ClusterState([Server(f"s{i}") for i in range(8)], profiles)
    ms = MaxShare(cluster)

    backbones = ["moment-large"] * 3 + ["dinov2-base"] * 2 + ["qwen2.5-3b"]
    placed = 0
    for i in range(60):
        t = TaskSpec(f"t{i}", backbones[i % len(backbones)], demand_rps=2.0)
        if ms.place(t):
            placed += 1
    print(f"placed {placed}/60 tasks on {len(cluster.deployments)} shared "
          f"deployments across {len(cluster.servers)} servers "
          f"(instance-per-task would need {placed} deployments)")

    ea = ElasticAdapter(cluster)
    r = ea.on_surge(TaskSpec("t0", "moment-large", demand_rps=2.0), 30.0)
    print(f"surge on t0 -> {r.path} (capacity ready in {r.ready_s*1e3:.0f} ms, "
          f"routed over {len(r.assignment)} deployment(s))")

    victim = next(iter(cluster.deployments.values())).server_id
    moved = ea.on_server_failure(victim)
    rebinds = sum(1 for m in moved if m.path == "rebind")
    print(f"server {victim} failed -> {len(moved)} tasks recovered "
          f"({rebinds} cheap rebinds, {len(moved)-rebinds} provisions)")
    return {"placed": placed, "deployments": len(cluster.deployments),
            "surge": r.path, "recovered": len(moved), "rebinds": rebinds}


if __name__ == "__main__":
    main()
