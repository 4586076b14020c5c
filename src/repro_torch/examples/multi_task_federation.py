"""Multi-tenant chain node: three federated tasks sharing one ledger.

The paper's blockchain layer is shared infrastructure — many collaborative
learning tasks settle on the same chain. Here one ``ChainNode`` serves
three heterogeneous MNIST federations (different worker counts, Merkle
chunk sizes, shard counts, and round cadences). Ticks where several tasks
fire seal ONE multi-task block committing the canonical
``task_id → super-root`` map; solo ticks seal the classic single-task
layout. Settlement proofs are three-level (chunk-in-shard, shard-in-task,
task-in-block) and a failing task would abort only its own round.

    PYTHONPATH=src python -m repro_torch.examples.multi_task_federation [--device cpu]
"""
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.node import ChainNode
from repro_torch.data.datasets import make_federated_mnist
from repro_torch.examples import device_arg
from repro_torch.serve import LightClient


def main(*, ticks: int = 12, samples: int = 1024, batch: int = 32,
         eval_samples: int = 256, device=None) -> dict:
    tc = TrainConfig(lr=0.01, momentum=0.5, optimizer="sgd")  # paper §IV
    cfg = get_config("paper-net")
    node = ChainNode(pipeline_depth=2, device=device)

    # three tenants: W=6 sharded task, W=4 two-cluster task, W=2 small task
    feds = {
        "hospital-fl": FederationConfig(
            num_clusters=2, workers_per_cluster=3, trust_threshold=0.3,
            top_k_rewarded=3, merkle_chunk_size=2, settlement_shards=2),
        "bank-fl": FederationConfig(
            num_clusters=2, workers_per_cluster=2, trust_threshold=0.4,
            top_k_rewarded=2, merkle_chunk_size=1),
        "iot-fl": FederationConfig(
            num_clusters=1, workers_per_cluster=2, trust_threshold=0.2,
            top_k_rewarded=1, merkle_chunk_size=4),
    }
    cadence = {"hospital-fl": 1, "bank-fl": 2, "iot-fl": 3}  # rounds/tick
    tasks = {tid: node.create_task(tid, cfg, fed, tc, seed=i)
             for i, (tid, fed) in enumerate(feds.items())}
    data = {tid: make_federated_mnist(t.W, samples=samples, seed=i)
            for i, (tid, t) in enumerate(tasks.items())}
    evals = {tid: data[tid].eval_batch(eval_samples) for tid in tasks}

    for t in range(ticks):
        firing = {tid: data[tid].round_batches(batch)
                  for tid in tasks if t % cadence[tid] == 0}
        node.run_tick(firing)
        print(f"tick {t:2d}  tasks={sorted(firing)}")
    node.flush()

    verified = node.ledger.verify_chain(deep=True)
    print(f"\nchain: {len(node.ledger.blocks)} blocks, "
          f"deep-verified={verified}")
    multi = [b for b in node.ledger.blocks if b.task_roots]
    print(f"multi-task blocks: {len(multi)} "
          f"(e.g. block {multi[0].index} commits "
          f"{sorted(multi[0].task_roots)})")

    # a light client audits a co-tenant block's three-level proof without
    # trusting the node: synced headers + a batched proof fetch
    auditor = LightClient(node.read_server())
    auditor.sync()
    batch_proof = auditor.fetch_proofs("hospital-fl", list(range(6)),
                                       round_index=0)
    proof_ok = auditor.verify_batch(batch_proof)
    print(f"3-level proofs for all 6 hospital-fl workers, round 0: "
          f"{batch_proof.num_digests} shared siblings, "
          f"verifies={proof_ok}, "
          f"worker 0 record={batch_proof.decoded(0)}")

    payouts = node.finalize()
    for tid, task in tasks.items():
        rounds = len(task.history)
        pen_total = sum(float(r.penalties.sum()) for r in task.history)
        trust = task.reputation.scores.round(2).tolist()
        print(f"\n[{tid}] rounds={rounds}  "
              f"final_acc={task.evaluate(evals[tid])['accuracy']:.3f}")
        print(f"  trust (reputation EMA): {trust}")
        print(f"  penalties collected: {pen_total:.1f}  "
              f"requester balance: {task.contract.requester_balance:.1f}")
        print(f"  payouts: {({k: round(v, 1) for k, v in payouts[tid].items()})}")
        print(f"  ipfs puts: {node.ipfs.puts_by_owner[tid]}")
    print(f"\nshared store: {node.ipfs.puts} puts, "
          f"{node.ipfs.bytes_stored / 1e6:.1f} MB stored, "
          f"{node.ipfs.dedup_hits} deduped")
    return {"verified": verified, "multi_blocks": len(multi),
            "proof_ok": proof_ok, "payouts": payouts,
            "rounds": {tid: len(t.history) for tid, t in tasks.items()}}


if __name__ == "__main__":
    main(device=device_arg())
