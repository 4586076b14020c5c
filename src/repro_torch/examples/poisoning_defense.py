"""Scenario: trust penalization defending against poisoning attacks.

Two attack levels, same defense:

- **worker-level** (the default): 8 workers in 2 clusters; two of them
  label-flip every round. Trust scores separate the attackers, stakes
  erode via Algorithm 1 penalties, accuracy is protected vs an
  unprotected run.
- **head-level** (``--head``): a byzantine *cluster head* poisons its
  entire cluster's contribution — every worker of cluster 0 ships
  flipped labels, standing in for a head that corrupts the cluster
  aggregate before publication. Same attacker count as the worker-level
  run, but *coherent*: the whole rogue cluster pulls in one poisoned
  direction instead of two scattered workers. The same per-worker trust
  scoring still catches it (the rogue cluster's workers all score low),
  soft trust weighting squeezes the poisoned cluster out of the global
  model, and the stake of every worker behind the rogue head erodes.

    PYTHONPATH=src python -m repro_torch.examples.poisoning_defense [--head] [--device cpu]
"""
import sys

from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import make_federated_mnist
from repro_torch.examples import device_arg

BAD = (0, 5)                  # worker-level attackers (scattered)
HEAD_CLUSTER_WORKERS = (0, 1)     # cluster 0 of 4 behind a byzantine head


def _flip_workers(batch, workers):
    """Label-flip the given workers' rows of a (W, 1, B) label tensor."""
    labels = batch["labels"].clone()
    rows = list(workers)
    labels[rows] = 9 - labels[rows]
    return {**batch, "labels": labels}


def flip(batch, round_index):
    return _flip_workers(batch, BAD)


def head_flip(batch, round_index):
    """Head-level poisoning: the rogue head taints its whole cluster."""
    return _flip_workers(batch, HEAD_CLUSTER_WORKERS)


def run(trust_on: bool, *, head_level: bool = False, rounds: int = 40,
        samples: int = 4096, eval_samples: int = 512, device=None) -> dict:
    # head-level: 4 clusters of 2 so the rogue head owns a whole (small)
    # cluster; worker-level: the original 2x4 layout
    fed = FederationConfig(num_clusters=4 if head_level else 2,
                           workers_per_cluster=2 if head_level else 4,
                           trust_threshold=0.45 if trust_on else -1.0,
                           soft_trust_weighting=trust_on, penalty_pct=5.0)
    tc = TrainConfig(lr=0.01, momentum=0.5, optimizer="sgd")
    proto = SDFLBProtocol(get_config("paper-net"), fed, tc, seed=0,
                          adversary=head_flip if head_level else flip,
                          device=device)
    ds = make_federated_mnist(8, samples=samples, seed=0)
    for _ in range(rounds):
        rec = proto.run_round(ds.round_batches(32))
    acc = proto.evaluate(ds.eval_batch(eval_samples))["accuracy"]
    proto.flush()   # pipelined driver: settle the trailing round first
    stakes = {w: proto.contract.workers[f"worker-{w}"].stake for w in range(8)}
    proto.finalize()
    return {"acc": acc, "scores": rec.scores, "stakes": stakes}


def main(head_level: bool = False, *, rounds: int = 40, samples: int = 4096,
         eval_samples: int = 512, device=None) -> dict:
    kw = dict(head_level=head_level, rounds=rounds, samples=samples,
              eval_samples=eval_samples, device=device)
    on = run(True, **kw)
    off = run(False, **kw)
    attackers = set(HEAD_CLUSTER_WORKERS if head_level else BAD)
    label = "byzantine head (cluster 0)" if head_level else "poisoning workers"
    print(f"attack: {label}")
    print("final trust scores (defended run):")
    for w in range(8):
        tag = "ATTACKER" if w in attackers else "honest"
        print(f"  worker {w} [{tag:8s}]  S={on['scores'][w]:.3f}  "
              f"stake_left={on['stakes'][w]:.1f}")
    print(f"\naccuracy with trust penalization   : {on['acc']:.3f}")
    print(f"accuracy without (uniform weights) : {off['acc']:.3f}")
    return {"defended": on, "undefended": off, "attackers": attackers}


if __name__ == "__main__":
    main(head_level="--head" in sys.argv[1:], device=device_arg())
