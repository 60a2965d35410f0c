"""TinyLlama-1.1B [arXiv:2401.02385]: 22L d=2048 32H kv=4 d_ff=5632
vocab=32000 (llama2 arch), as the reference configures it."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="tinyllama-1.1b", family="dense", n_layers=22, d_model=2048,
        n_heads=32, n_kv_heads=4, head_dim=64, d_ff=5632, vocab_size=32000,
        act="silu", norm="rms", tie_embeddings=False, max_seq_len=32768)
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=14, s=55, warmup_steps=200),
        optimizer=OptimizerConfig(name="adamw", lr=4e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=200,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=4, remat="block"),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: pure full attention (quadratic).")
