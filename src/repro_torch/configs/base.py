"""Configuration dataclasses, mirrored field for field from the reference.

The reference's ``repro.configs.base`` cannot be imported here (it pulls in
``repro.core`` and therefore JAX), so the configs the port reads are
copied: the same fields, the same defaults, the same order. A test pins
them against the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

from repro_torch.core.schedule import DMDGroupRule


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 1
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    weight_stationary: bool = True


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 0
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk: int = 256


@dataclass(frozen=True)
class ModelConfig:
    """One architecture's shapes, field for field the reference's: the
    dense (gemma's local/global windows included), MoE, SSM, hybrid,
    enc-dec (the encoder, learned positions, LayerNorm) and VLM (M-RoPE)
    families."""
    name: str = "model"
    family: str = "dense"           # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 64
    d_ff: int = 256
    vocab_size: int = 256
    act: str = "silu"               # silu | gelu | gelu_mlp | softsign
    norm: str = "rms"               # rms | ln
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    sliding_window: int = 0
    global_every: int = 0
    tie_embeddings: bool = True
    max_seq_len: int = 8192
    moe: MoEConfig = field(default_factory=MoEConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    shared_attn_every: int = 0
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0
    learned_pos_emb: bool = False
    frontend_stub: bool = False
    dtype: str = "bfloat16"
    logit_softcap: float = 0.0
    vocab_pad_to: int = 16

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return -(-self.vocab_size // p) * p if p else self.vocab_size

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclass(frozen=True)
class DMDControllerConfig:
    """Loss-gated adaptive jump controller (DESIGN.md §5). The port does not
    run the controller yet; the config is carried so ``resolve_groups`` can
    read ``enabled``/``energy``/``ridge`` exactly as the reference does."""
    enabled: bool = False
    eval_rows: int = 32
    accept_tol: float = 1e-3
    val_gate: bool = False
    grow: float = 1.5
    shrink: float = 0.5
    s_min: float = 1.0
    relax_floor: float = 0.125
    gain_ema: float = 0.8
    energy: float = 0.995
    ridge: float = 0.0
    ridge_max: float = 0.1
    shrink_levels: Tuple[float, ...] = (0.5,)
    meta_lr: float = 0.0


@dataclass(frozen=True)
class DMDConfig:
    enabled: bool = True
    m: int = 14                     # snapshots per DMD round (paper: 14)
    s: int = 55                     # extrapolation horizon (paper: 55)
    tol: float = 1e-4               # sigma_r / sigma_0 > tol (fp32 floor)
    atol: float = 0.0               # absolute sigma floor; 0 = off
    warmup_steps: int = 100
    cooldown_steps: int = 10
    mode: str = "matpow"            # matpow | eig
    clamp_eigs: bool = False
    anchor: str = "first"           # none | first | mean
    affine: bool = True
    trust_region: float = 2.0
    relax: float = 1.0
    snapshot_dtype: str = "float32"  # float32 | bfloat16 snapshot storage
    gram_upcast: bool = True
    streaming_gram: bool = True     # carry the (n_sys, m, m) Gram; False =
                                    # recompute it at every jump
    arena: bool = True              # packed block-major buckets; False =
                                    # per-leaf buffers (the A/B oracle)
    arena_block_n: int = 512
    arena_native: bool = True
    scope: str = "leaf"             # leaf | bucket
    kernel_route: str = "auto"
    param_filter: str = "all"
    min_param_size: int = 0
    groups: Tuple[DMDGroupRule, ...] = ()
    anneal: float = 1.0
    controller: DMDControllerConfig = field(
        default_factory=DMDControllerConfig)
    reset_opt_state: bool = True


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adam"              # sgd | momentum | adam (ported so far)
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    schedule: str = "constant"      # constant (ported so far)
    warmup_steps: int = 0
    total_steps: int = 10000
    decay_fraction: float = 0.1
    min_lr_ratio: float = 0.1


@dataclass(frozen=True)
class ParallelConfig:
    grad_accum: int = 1
    remat: str = "none"
    zero1_over_pod: bool = False
    grad_compression: str = "none"
    scan_layers: bool = True
    pad_attn_heads_to: int = 0
    kv_seq_shard_threshold: int = 16


@dataclass(frozen=True)
class TrainConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3


@dataclass(frozen=True)
class ShapeConfig:
    """One dry-run cell: (kind, seq_len, global_batch)."""
    name: str = "train_4k"
    kind: str = "train"              # train | prefill | decode
    seq_len: int = 4096
    global_batch: int = 256


STANDARD_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)


@dataclass(frozen=True)
class ArchConfig:
    """Everything needed to build and run one architecture."""
    model: ModelConfig
    dmd: DMDConfig = field(default_factory=DMDConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skip_notes: str = ""

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def reduced(model: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU tests (the reference's rule)."""
    shrink = dict(
        n_layers=min(model.n_layers, 4),
        d_model=min(model.d_model, 64),
        n_heads=min(model.n_heads, 4),
        n_kv_heads=min(model.n_kv_heads, 2),
        head_dim=min(model.head_dim, 16),
        d_ff=min(model.d_ff, 128),
        vocab_size=min(model.vocab_size, 512),
        max_seq_len=min(model.max_seq_len, 256),
    )
    if model.n_kv_heads == model.n_heads:       # keep MHA shape relation
        shrink["n_kv_heads"] = shrink["n_heads"]
    if model.n_kv_heads == 1:
        shrink["n_kv_heads"] = 1
    if model.moe.n_experts > 0:
        shrink["moe"] = dataclasses.replace(
            model.moe, n_experts=min(model.moe.n_experts, 8),
            top_k=min(model.moe.top_k, 2),
            expert_d_ff=min(model.moe.expert_d_ff, 64),
            shared_d_ff=min(model.moe.shared_d_ff, 64),
        )
    if model.ssm.state_dim > 0:
        shrink["ssm"] = dataclasses.replace(
            model.ssm, state_dim=min(model.ssm.state_dim, 16),
            head_dim=min(model.ssm.head_dim, 16), chunk=32)
    if model.n_encoder_layers > 0:
        shrink["n_encoder_layers"] = min(model.n_encoder_layers, 2)
        shrink["encoder_seq_len"] = min(model.encoder_seq_len, 32)
    if model.global_every > 0:
        shrink["n_layers"] = max(shrink["n_layers"], model.global_every)
    if model.shared_attn_every > 0:
        shrink["n_layers"] = max(shrink["n_layers"], model.shared_attn_every)
    if model.sliding_window > 0:
        shrink["sliding_window"] = min(model.sliding_window, 32)
    if model.mrope_sections:
        hd = shrink.get("head_dim", model.head_dim)
        s1 = max(hd // 8, 1)
        rest = hd // 2 - s1
        shrink["mrope_sections"] = (s1, rest // 2, rest - rest // 2)
    shrink.update(overrides)
    return dataclasses.replace(model, **shrink)
