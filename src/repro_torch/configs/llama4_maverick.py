"""Llama4-Maverick-400B-A17B [hf:meta-llama/Llama-4]: 48L d=5120 40H kv=8
hd=128 vocab=202048; MoE 128 experts top-1 + a shared expert (d_ff 8192),
interleaved 1:1 with dense layers (d_ff 16384), as the reference
configures it. DMD leaves the experts out (param_filter "non_expert"):
top-1 expert trajectories are sparse, and m snapshots of the experts would
not fit. Adafactor's factored second moment keeps the optimizer small."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      MoEConfig, OptimizerConfig,
                                      ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="llama4-maverick-400b-a17b", family="moe", n_layers=48,
        d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=16384,
        vocab_size=202048, act="silu", norm="rms", rope_theta=5e5,
        tie_embeddings=False, max_seq_len=32768,
        moe=MoEConfig(n_experts=128, top_k=1, expert_d_ff=8192,
                      n_shared_experts=1, shared_d_ff=8192, moe_every=2,
                      capacity_factor=1.25))
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=8, s=40, snapshot_dtype="bfloat16",
                      param_filter="non_expert", warmup_steps=200),
        optimizer=OptimizerConfig(name="adafactor", lr=2e-4, b2=0.99,
                                  grad_clip=1.0, schedule="cosine",
                                  warmup_steps=500, total_steps=20000),
        parallel=ParallelConfig(grad_accum=8, remat="block",
                                pad_attn_heads_to=16),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: pure full attention (quadratic).")
