"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B]: 48L d=2048 32H kv=4 hd=128
vocab=151936; MoE 128 experts top-8, expert d_ff=768, every layer MoE, as
the reference configures it. DMD covers every parameter, experts included
(param_filter "all", bf16 snapshots, m 8, s 40): top-8 routing gives
expert update trajectories dense enough for it."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig,
                                      ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="qwen3-moe-30b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=128, d_ff=768, vocab_size=151936,
        act="silu", norm="rms", rope_theta=1e6, tie_embeddings=False,
        max_seq_len=32768,
        moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=768,
                      moe_every=1, capacity_factor=1.25))
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=8, s=40, snapshot_dtype="bfloat16",
                      param_filter="all", warmup_steps=200),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=200,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=4, remat="block"),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: pure full attention (quadratic).")
