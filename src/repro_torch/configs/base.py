"""Config dataclasses for the SDFL-B framework.

Every assigned architecture gets a module in this package exporting
``CONFIG: ModelConfig`` (full-size, dry-run only) and ``smoke_config()``
(reduced variant instantiable on CPU). ``repro_torch.configs.registry`` maps
``--arch <id>`` to these.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration."""
    num_experts: int = 0            # routed experts
    top_k: int = 0
    d_ff_expert: int = 0            # per-expert hidden dim
    num_shared_experts: int = 0     # always-on shared experts
    d_ff_shared: int = 0            # per-shared-expert hidden dim
    router_aux_loss: float = 0.01   # load-balance loss coefficient
    router_z_loss: float = 0.001
    capacity_factor: float = 1.25   # GShard-style capacity (tokens dropped
                                    # beyond C = ceil(k·T/E·cf))

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba2 / xLSTM) block configuration."""
    state_dim: int = 0              # N: per-channel state size (Mamba2) / head state (mLSTM)
    conv_width: int = 4
    expand: int = 2                 # inner dim = expand * d_model
    num_ssm_heads: int = 0          # Mamba2 SSD heads (0 => derived)
    chunk_size: int = 256           # SSD chunked-scan block length

    @property
    def enabled(self) -> bool:
        return self.state_dim > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek/MiniCPM3-style) configuration."""
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. ``family`` selects the block builder:

    dense  : pre-norm decoder-only transformer (llama-style)
    moe    : dense attention + MoE MLP
    ssm    : xLSTM (mLSTM/sLSTM mix) or pure-Mamba2 stacks
    hybrid : Mamba2 backbone + shared attention block (zamba2)
    vlm    : dense decoder consuming early-fused token+patch embeddings
    audio  : encoder-decoder consuming stub mel-frame embeddings (whisper)
    cnn    : the paper's own MNIST Net (conv1/conv2/dropout/fc1/fc2)
    """
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                       # 0 => d_model // num_heads
    # --- attention flavor ---
    attn_type: str = "gqa"                  # gqa | mla | swa
    window: int = 0                         # SWA window (attn_type == "swa")
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- sub-configs ---
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    # --- hybrid (zamba2): shared attention block every k-th layer ---
    shared_attn_every: int = 0              # 0 => no shared block
    # --- xLSTM: put an sLSTM block every k-th layer (rest mLSTM) ---
    slstm_every: int = 0
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500                 # mel-frame count (stub frontend output)
    # --- vlm (chameleon): stub patch-embedding frontend ---
    num_patch_tokens: int = 0               # patches prepended per sample
    # --- paper CNN ---
    image_size: int = 28
    num_classes: int = 10
    cnn_channels: Tuple[int, int] = (10, 20)
    # --- numerics / citation ---
    dtype: str = "bfloat16"
    source: str = ""                        # citation bracket from the assignment

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode path exists (SSM state or sliding window)."""
        return self.family in ("ssm", "hybrid") or self.attn_type == "swa"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """An assigned input shape. ``kind`` picks train_step vs serve_step."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                               # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


@dataclass(frozen=True)
class FederationConfig:
    """SDFL-B protocol configuration (the paper's technique)."""
    task_id: str = "task-0"                 # name of this task on a (possibly
                                            # multi-tenant) chain node — keys
                                            # its contract's commits in
                                            # multi-task blocks
    num_clusters: int = 4
    workers_per_cluster: int = 4            # data axis = clusters * workers
    # Algorithm 1 economics
    requester_deposit: float = 1000.0       # D
    worker_stake: float = 10.0              # F
    penalty_pct: float = 50.0               # P (percent of F)
    trust_threshold: float = 0.5            # T on the normalized score
    top_k_rewarded: int = 4                 # k
    # trust score blend (EvaluatePerformance): cosine, norm-dev, loss terms
    w_cosine: float = 0.5
    w_norm: float = 0.3
    w_loss: float = 0.2
    # trust weighting of aggregation (0 => paper-faithful hard filter only)
    soft_trust_weighting: bool = True
    # async functionality
    async_mode: bool = False
    staleness_alpha: float = 0.5            # weight = 1 / (1 + staleness)**alpha
    buffer_size: int = 8                    # FedBuff-style buffer capacity; on
                                            # the event-driven node this is the
                                            # per-task arrival-buffer size an
                                            # aggregation event waits for
    max_wait: float = float("inf")          # event-driven node: max simulated
                                            # seconds an aggregation event
                                            # waits for the buffer to fill
                                            # before sealing whatever cohort
                                            # arrived (inf = fill the buffer)
    # aggregation topology
    mode: str = "allreduce"                 # "allreduce" | "head_gather" (paper-faithful)
    head_rotation_seed: int = 0
    fused_trust_path: str = "auto"          # flat-pack + fused Pallas trust
                                            # round (kernels.fused_round):
                                            # the cohort's updates pack into
                                            # ONE (W, D) matrix and trust
                                            # stats + weighted aggregation
                                            # run in two streamed HBM passes
                                            # instead of ~5 per-leaf sweeps.
                                            # "auto" engages for unsharded
                                            # flat/CNN param trees (uniform
                                            # leaf dtype, no mesh
                                            # constraints); "on" forces it
                                            # (errors on unpackable trees);
                                            # "off" keeps the per-leaf
                                            # reference path everywhere.
                                            # Value-equivalent to every
                                            # aggregation ``mode`` (the
                                            # hierarchy telescopes)
    # chain-layer scaling knobs
    merkle_chunk_size: int = 64             # settlement records per Merkle
                                            # leaf (commit hashes ~2W/k nodes;
                                            # proofs O(log(W/k)) + k)
    pipeline_depth: int = 2                 # pending rounds the background
                                            # settler may hold (0 = settle
                                            # inline on the training thread)
    settlement_shards: int = 1              # contract shards per round: slices
                                            # settle + hash their own Merkle
                                            # subtree in parallel under one
                                            # cross-shard super-root (subtree-
                                            # aligned, so block hashes are
                                            # shard-count independent)
    settler_pool_size: int = 0              # shard-worker threads draining the
                                            # per-shard queues (0 = auto:
                                            # min(settlement_shards, cpus),
                                            # spawned only when the leaf-size
                                            # gate could feed them; an explicit
                                            # size forces the spawn; effective
                                            # only with pipeline_depth > 0 and
                                            # shards > 1). On a multi-tenant
                                            # ChainNode the pool is shared:
                                            # node-level sizing takes the max
                                            # shard count across tasks
    sparse_settlement: bool = False         # settle rounds as incremental
                                            # DeltaCommits over the full
                                            # population: only the round's
                                            # changed records (the workers
                                            # that participated, per the
                                            # participation mask) re-hash —
                                            # O(C·log(W/k)) per round instead
                                            # of O(W/k) — while every block
                                            # still commits (and proves) all
                                            # W workers' latest records. The
                                            # million-worker mode; block
                                            # hashes differ from the dense
                                            # path (full-population root)
    sparse_rebase_every: int = 0            # re-anchor the delta chain with a
                                            # dense full-population commit
                                            # every N sparse rounds (0 = only
                                            # when forced: first round, after
                                            # enrollment growth, or full
                                            # participation). Bounds deep-
                                            # verify replay depth and the
                                            # overlay-chain walk of audits


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.01                        # paper: SGD lr=0.01
    momentum: float = 0.5                   # paper: momentum=0.5
    dampening: float = 0.0
    weight_decay: float = 0.0
    nesterov: bool = False
    optimizer: str = "sgd"                  # "sgd" (paper) | "adamw" (LLM configs)
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    grad_clip: float = 0.0
    local_steps: int = 1                    # local SGD steps per FL round
    remat: bool = True
    seed: int = 0
    opt_dtype: str = "float32"              # optimizer-state dtype ("bfloat16"
                                            # for the biggest archs: memory fit)
    kv_chunk: int = 512                     # flash-attention KV chunk (train)
