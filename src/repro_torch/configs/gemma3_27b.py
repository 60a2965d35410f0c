"""Gemma3-27B [hf:google/gemma-3]: 62L d=5376 32H kv=16 (head_dim 128)
d_ff=21504 vocab=262144, gated GELU, rope theta 1e6, 5:1 local (window
1024) : global attention, tied embeddings, as the reference configures
it. 62 = 10 x (5 local + 1 global) + 2 local layers. The local layers'
decode caches are rings of the window's 1024 slots
(``models/attention.py`` ``RingKVCache``)."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="gemma3-27b", family="dense", n_layers=62, d_model=5376,
        n_heads=32, n_kv_heads=16, head_dim=128, d_ff=21504,
        vocab_size=262144, act="gelu", norm="rms", rope_theta=1e6,
        sliding_window=1024, global_every=6, tie_embeddings=True,
        max_seq_len=524288)
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=8, s=40, snapshot_dtype="bfloat16", warmup_steps=200),
        optimizer=OptimizerConfig(name="adamw", lr=2e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=200,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=16, remat="block"),
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"))
