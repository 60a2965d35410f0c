"""Mamba2-2.7B [arXiv:2405.21060]: 64L d=2560 attention-free SSD
(d_inner=5120, H=80, P=64, N=128, chunk=256), vocab=50280, as the
reference configures it. DMD covers every parameter (bf16 snapshots, m 14,
s 55)."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      SSMConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        act="silu", norm="rms", tie_embeddings=True, max_seq_len=524288,
        ssm=SSMConfig(state_dim=128, head_dim=64, conv_width=4, expand=2,
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
