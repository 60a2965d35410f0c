"""Zamba2-2.7B [arXiv:2411.15242]: 54 Mamba-2 layers d=2560 (d_inner=5120,
H=80, P=64, N=64) + ONE shared attention+MLP block invoked after every 6
Mamba layers (weights stored once; the paper's per-invocation LoRA is left
out, as the reference leaves it out). Attention: 32 heads of 80, MHA;
d_ff=10240. As the reference configures it; DMD covers every parameter
(bf16 snapshots, m 14, s 55)."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      SSMConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560,
        n_heads=32, n_kv_heads=32, head_dim=80, d_ff=10240, vocab_size=32000,
        act="silu", norm="rms", shared_attn_every=6, tie_embeddings=True,
        max_seq_len=524288,
        ssm=SSMConfig(state_dim=64, head_dim=64, conv_width=4, expand=2,
                      n_groups=1, chunk=256))
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=14, s=55, snapshot_dtype="bfloat16", warmup_steps=200),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=200,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=8, remat="block"),
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"))
