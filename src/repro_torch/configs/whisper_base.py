"""Whisper-base [arXiv:2212.04356]: enc-dec, 6+6L d=512 8H d_ff=2048
vocab=51865, LayerNorm, the plain GELU MLP and learned positions, as the
reference configures it. The conv frontend is a STUB: the batch carries
precomputed (B, 1500, 512) frame embeddings. max_seq_len is the
reference's 32768 (real Whisper caps the decoder's context at 448).
88,175,616 params."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig)


def get_config() -> ArchConfig:
    model = ModelConfig(
        name="whisper-base", family="encdec", n_layers=6, n_encoder_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
        vocab_size=51865, act="gelu_mlp", norm="ln", learned_pos_emb=True,
        encoder_seq_len=1500, frontend_stub=True, tie_embeddings=True,
        max_seq_len=32768)
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=14, s=55, warmup_steps=100),
        optimizer=OptimizerConfig(name="adamw", lr=1e-3, grad_clip=1.0,
                                  schedule="cosine", warmup_steps=100,
                                  total_steps=10000),
        parallel=ParallelConfig(grad_accum=1, remat="none",
                                pad_attn_heads_to=16),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skip_notes="long_500k skipped: enc-dec with full attention; 8 heads "
                   "< tp=16 -> kv-SP attention layout.")
