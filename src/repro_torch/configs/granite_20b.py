"""Granite-20B-code [arXiv:2405.04324]: 52L d=6144 48H MQA (one kv head,
head_dim 128) d_ff=24576 vocab=49152, the non-gated GELU MLP (GPT-BigCode
lineage), untied head, as the reference configures it. Its 40.6 GB of
bf16 weights fit one 80 GB card: the port serves it without a mesh."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="granite-20b", family="dense", n_layers=52, d_model=6144,
        n_heads=48, n_kv_heads=1, head_dim=128, d_ff=24576, vocab_size=49152,
        act="gelu_mlp", norm="rms", tie_embeddings=False,
        max_seq_len=32768)
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=8, s=40, snapshot_dtype="bfloat16", warmup_steps=200),
        optimizer=OptimizerConfig(name="adamw", lr=2e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=200,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=16, remat="block"),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: pure full attention (MQA shrinks the "
                   "KV but attention is still full).")
