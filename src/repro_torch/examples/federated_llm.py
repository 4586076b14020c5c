"""Scenario: the generic-codebase claim (paper §VI.D) — the same SDFL-B
protocol federating an LLM architecture (any of the port's dense or MoE
decoders, the zamba2 hybrid or xLSTM via --arch; smoke size here, full
size through ``repro_torch.launch.train --full``).

    PYTHONPATH=src python -m repro_torch.examples.federated_llm \\
        [--arch qwen2-moe-a2.7b] [--rounds 5] [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs.base import FederationConfig, TrainConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.core.protocol import SDFLBProtocol
from repro_torch.data.datasets import synthetic_tokens

# the port's LLM archs: the dense and MoE decoders, the hybrid and xLSTM;
# not the VLM nor the audio family, whose batches need the stub frontends'
# ``patch_embeds`` or ``frames`` that ``synthetic_tokens`` does not make
# (the reference's example stops at ``batch["patch_embeds"]`` there)
LLM_ARCHS = [a for a in ARCH_IDS
             if get_config(a).family in ("dense", "moe", "hybrid", "ssm")]


def main(*, arch: str = "smollm-135m", rounds: int = 5,
         device=None) -> dict:
    cfg = get_smoke_config(arch)
    fed = FederationConfig(num_clusters=2, workers_per_cluster=2,
                           trust_threshold=0.1)
    tc = TrainConfig(optimizer="adamw", lr=3e-4, grad_clip=1.0, remat=False)
    proto = SDFLBProtocol(cfg, fed, tc, use_blockchain=True, seed=0,
                          device=device)

    losses = []
    for r in range(rounds):
        data = synthetic_tokens(4, 2, 128, cfg.vocab_size, seed=r)
        rec = proto.run_round(data)
        losses.append(float(np.mean(rec.losses)))
        print(f"round {r + 1}: mean_loss={losses[-1]:.3f} "
              f"trust={rec.scores.round(2).tolist()}")
    proto.finalize()
    verified = proto.ledger.verify_chain()
    print("ledger verified:", verified)
    return {"losses": losses, "scores": [r.scores for r in proto.history],
            "verified": verified, "blocks": len(proto.ledger.blocks)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=LLM_ARCHS)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(arch=args.arch, rounds=args.rounds, device=args.device)
