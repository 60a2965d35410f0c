"""MiniCPM-2B [arXiv:2404.06395]: 40L d=2304 36H MHA (head_dim 64)
d_ff=5760 vocab=122753, the WSD schedule, tied embeddings, as the
reference configures it. ``pad_attn_heads_to=16`` is the reference's
head-TP layout for 36 heads over a 16-way model axis (zero heads that add
nothing, ``src/repro/models/attention.py`` ``pad_heads``); the port runs
on one card and ignores it: the same values."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv_heads=36, head_dim=64, d_ff=5760, vocab_size=122753,
        act="silu", norm="rms", tie_embeddings=True, max_seq_len=32768)
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=14, s=55, snapshot_dtype="bfloat16"),
        optimizer=OptimizerConfig(name="adamw", lr=3e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="wsd", warmup_steps=200,
                                  total_steps=10000, decay_fraction=0.1),
        parallel=ParallelConfig(grad_accum=8, remat="block",
                                pad_attn_heads_to=16),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: pure full attention (quadratic).")
