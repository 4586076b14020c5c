"""Scenario: asynchronous SDFL-B with stragglers, failures, and a
co-tenant straggler task — the event-driven node end to end.

Task "fast": 8 workers, 25% of them 6x slower and occasionally dropping
updates (churn). The node's arrival frontier decides when enough updates
arrived (buffer of 4); staleness-discounted aggregation folds late updates
in when they show up, and each event seals exactly the arrived cohort
on-chain with its staleness in the settlement records. Task "slow" shares
the same chain node with 10x slower workers — events interleave by
simulated time, so the straggler task never stalls the fast one.

    PYTHONPATH=src python -m repro_torch.examples.async_federation [--device cpu]
"""
import numpy as np

from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import async_sim
from repro_torch.core.node import ChainNode
from repro_torch.data.datasets import make_federated_mnist
from repro_torch.examples import device_arg
from repro_torch.serve import LightClient


def _fed(task_id: str) -> FederationConfig:
    return FederationConfig(num_clusters=2, workers_per_cluster=4,
                            trust_threshold=0.2, async_mode=True,
                            staleness_alpha=0.5, buffer_size=4,
                            task_id=task_id)


def main(*, events: int = 45, samples: int = 4096, batch: int = 32,
         eval_samples: int = 512, device=None) -> dict:
    W = 8
    cfg = get_config("paper-net")
    tc = TrainConfig(lr=0.01, momentum=0.5, optimizer="sgd")
    node = ChainNode(pipeline_depth=2, device=device)

    # churn profile: 25% stragglers 6x slower, 5% of updates lost
    churn = async_sim.heterogeneous_profiles(
        W, straggler_frac=0.25, straggler_slowdown=6.0, failure_prob=0.05,
        seed=0)
    fast = node.create_task("fast", cfg, _fed("fast"), tc, seed=0,
                            profiles=churn)
    slow_profiles = [async_sim.WorkerProfile(speed=10.0, jitter=0.2)
                     for _ in range(W)]
    node.create_task("slow", cfg, _fed("slow"), tc, seed=1,
                     profiles=slow_profiles)

    ds = {tid: make_federated_mnist(W, samples=samples, seed=i)
          for i, tid in enumerate(("fast", "slow"))}
    ev = ds["fast"].eval_batch(eval_samples)

    sync_barrier = async_sim.AsyncScheduler(churn, seed=0, buffer_size=W)
    fns = {tid: (lambda r, d=d: d.round_batches(batch))
           for tid, d in ds.items()}
    recs, printed = {"fast": [], "slow": []}, 0
    for _ in range(events // 5):
        new = node.run_events(fns, events=5)
        for tid in recs:
            recs[tid].extend(new[tid])
        while len(recs["fast"]) >= printed + 10:
            printed += 10
            rec = recs["fast"][printed - 1]
            m = fast.evaluate(ev)
            cohort = rec.participation > 0
            lat = rec.sim_time - rec.arrival_times[cohort]
            print(f"event {printed:3d}  t={rec.sim_time:7.2f}s  "
                  f"arrived={int(cohort.sum())}/{W}  "
                  f"seal_latency_p95={np.percentile(lat, 95):.2f}s  "
                  f"acc={m['accuracy']:.3f}")
    node.flush()
    t = recs["fast"][-1].sim_time
    sync_clock = sum(sync_barrier.sync_round_time()
                     for _ in range(len(recs["fast"])))
    print(f"\nfast task: {len(recs['fast'])} events, "
          f"slow co-tenant: {len(recs['slow'])} events "
          f"(chain never waits for the straggler task)")
    print(f"async speedup vs slowest-worker barrier: {sync_clock / t:.2f}x")

    # per-worker staleness / penalty summary, straight off the chain
    print(f"\n{'worker':>6} {'events':>7} {'max_stale':>9} "
          f"{'penalty':>9} {'stake':>7}")
    n_events = np.zeros(W, int)
    max_stale = np.zeros(W, int)
    for rec in recs["fast"]:
        n_events += rec.participation > 0
        max_stale = np.maximum(max_stale, rec.staleness)
    pen = fast.reputation.penalties
    for w in range(W):
        print(f"{w:>6} {n_events[w]:>7} {max_stale[w]:>9} "
              f"{pen[w]:>9.2f} {fast.contract.stake[w]:>7.2f}")

    assert node.ledger.verify_chain(deep=True)
    # an external auditor: header-only light client fetches + verifies
    # worker 0's last cohort record straight off the read server
    auditor = LightClient(node.read_server())
    auditor.sync()
    record = auditor.audit("fast", 0,
                           round_index=recs["fast"][-1].round_index)
    print(f"\nchain deep-verified; light-client audit of worker 0's last "
          f"settlement record (staleness on-chain): {record}")
    node.finalize()
    return {"records": recs, "record": record,
            "speedup": sync_clock / t}


if __name__ == "__main__":
    main(device=device_arg())
