"""Quickstart: the paper's experiment in ~40 lines.

Three workers train the paper's MNIST CNN under the SDFL-B protocol —
cluster aggregation, trust scoring, on-chain settlement, IPFS-published
models — then the contract is finalized and rewards paid.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import make_federated_mnist
from repro_torch.examples import device_arg
from repro_torch.serve import LightClient


def main(*, rounds: int = 30, samples: int = 2048, batch: int = 64,
         eval_samples: int = 512, device=None) -> dict:
    fed = FederationConfig(num_clusters=1, workers_per_cluster=3,
                           trust_threshold=0.2)
    tc = TrainConfig(lr=0.01, momentum=0.5, optimizer="sgd")  # paper §IV
    proto = SDFLBProtocol(get_config("paper-net"), fed, tc,
                          use_blockchain=True, seed=0, device=device)
    ds = make_federated_mnist(3, samples=samples, seed=0)
    eval_batch = ds.eval_batch(eval_samples)

    metrics = {}
    for round_index in range(rounds):
        rec = proto.run_round(ds.round_batches(batch))
        if (round_index + 1) % 10 == 0 or round_index + 1 == rounds:
            metrics = proto.evaluate(eval_batch)
            # the pipelined driver settles a round during the next round's
            # device step, so the freshest settled cid is the previous one
            settled = next((r for r in reversed(proto.history) if r.settled),
                           rec)
            cid = (settled.model_cid or "")[:12]
            print(f"round {round_index + 1:3d}  "
                  f"acc={metrics['accuracy']:.3f}  "
                  f"loss={metrics['loss']:.3f}  "
                  f"trust={rec.scores.round(2).tolist()}  "
                  f"heads={rec.heads}  cid={cid}…")

    # audit a worker without trusting the node: a light client holds only
    # verified headers, fetches a settlement proof, and checks it itself
    auditor = LightClient(proto.node.read_server())
    auditor.sync()
    record = auditor.audit(None, 0)
    print(f"\nlight-client audit (headers only, {auditor.height} synced): "
          f"worker 0 settled round {record['round']} with "
          f"score={record['score']:.3f} stake={record['stake_after']:.1f}")

    payouts = proto.finalize()
    verified = proto.ledger.verify_chain()
    print("ledger verified:", verified,
          f"({len(proto.ledger.blocks)} blocks, {proto.ipfs.puts} IPFS puts)")
    print("payouts:", {k: round(v, 2) for k, v in payouts.items()})
    return {"metrics": metrics, "record": record, "payouts": payouts,
            "verified": verified}


if __name__ == "__main__":
    main(device=device_arg())
