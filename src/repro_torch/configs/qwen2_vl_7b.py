"""Qwen2-VL-7B [arXiv:2409.12191]: 28L d=3584 28H kv=4 d_ff=18944
vocab=152064, M-RoPE (t/h/w sections 16/24/24 of head_dim/2=64), as the
reference configures it. The vision tower is a STUB: the backbone takes
token ids and (B, 3, S) M-RoPE position ids. 7,615,487,488 params, 15.23
GB in bf16: it generates on one card; its training state (274 GB at 36 B
a param) does not fit one."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, head_dim=128, d_ff=18944,
        vocab_size=152064, act="silu", norm="rms", rope_theta=1e6,
        mrope_sections=(16, 24, 24), frontend_stub=True,
        tie_embeddings=False, max_seq_len=32768)
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=10, s=40, snapshot_dtype="bfloat16", warmup_steps=200),
        optimizer=OptimizerConfig(name="adamw", lr=2e-4, b2=0.95,
                                  weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=200,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=8, remat="block",
                                pad_attn_heads_to=16),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: pure full attention (quadratic).")
