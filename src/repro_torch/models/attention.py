"""Attention of the dense LM: GQA with RoPE and a KV cache.

Two cores, chosen by what the call attends:

  * the whole in-context sequence (``forward``, and prefill into a fresh
    cache: query offset the host integer 0, every key in context) goes to
    ``kernels.ops.flash_attention``, the flash-attention kernel K7 on the
    card and its plain twin on the CPU; in training (q, k and v require a
    gradient) its backward is K7b on the card and autograd through the
    twin on the CPU;
  * everything else (decode against a cache, per-row cache lengths) goes to
    ``blockwise_attention``, plain torch: the reference's jnp online-softmax
    core, which is not a Pallas kernel there either.

``blockwise_attention`` keeps the reference's absolute ``chunk_k`` key
grid: keys past the cache length are masked to -1e30 and add exact zeros
on the same chunk boundaries whatever the cache's size, which is what
keeps a padded prompt's tokens equal to an exact-length run's.

Caches are updated in place (the reference donates them; here the write
lands in the caller's tensors and the returned cache shares them).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

NEG_INF = -1e30

Length = Union[int, torch.Tensor]


def attn_init(gen: torch.Generator, cfg, device,
              stack: Tuple[int, ...] = ()) -> dict:
    dtype = getattr(torch, cfg.dtype)
    d, q, kv = cfg.d_model, cfg.q_dim, cfg.kv_dim
    return {"wq": layers.dense_init(gen, stack + (d, q), dtype, device),
            "wk": layers.dense_init(gen, stack + (d, kv), dtype, device),
            "wv": layers.dense_init(gen, stack + (d, kv), dtype, device),
            "wo": layers.dense_init(gen, stack + (q, d), dtype, device)}


class KVCache(NamedTuple):
    """k, v: (..., B, s_max, K, hd). ``length`` is the valid prefix: a host
    int shared by every row (prefill, the exact-length loop), or a (B,)
    integer tensor of per-row lengths (the serving engine's slot table)."""
    k: torch.Tensor
    v: torch.Tensor
    length: Length


def init_kv_cache(batch: int, s_max: int, n_kv: int, head_dim: int, dtype,
                  device, stack: Tuple[int, ...] = ()) -> KVCache:
    shape = stack + (batch, s_max, n_kv, head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        q_offset: Length = 0,
                        kv_len: Optional[Length] = None,
                        chunk_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv chunks of ``chunk_k`` keys.

    q (B, Sq, H, hd); k/v (B, Sk, K, hd), H % K == 0. ``q_offset`` is the
    absolute position of q[:, 0] and ``kv_len`` masks keys at and past it;
    each is an int or a (B,) tensor (one per row). The last chunk is padded
    with masked zero keys, so every chunk has ``chunk_k`` keys.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=dev))
    qg = (q.float() * scale).reshape(B, Sq, K, rep, hd)

    n_chunks = max(-(-Sk // chunk_k), 1)
    pad = n_chunks * chunk_k - Sk
    k_pos = torch.arange(n_chunks * chunk_k, device=dev)
    if pad:
        k_pos[Sk:] = -1
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    if isinstance(q_offset, torch.Tensor):
        q_pos = q_offset.reshape(B, 1) + torch.arange(Sq, device=dev)
    else:
        q_pos = (torch.arange(Sq, device=dev) + q_offset).reshape(1, Sq)
    limit = Sk if kv_len is None else kv_len
    if isinstance(limit, torch.Tensor):
        limit = limit.reshape(B, 1, 1)

    m = torch.full((B, K, rep, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, rep, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, rep, Sq, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        chunk = slice(c * chunk_k, (c + 1) * chunk_k)
        kp = k_pos[chunk]
        s = torch.einsum("bsgrh,bcgh->bgrsc", qg, k[:, chunk].float())
        rel = q_pos[:, :, None] - kp                     # (B|1, Sq, ck)
        mask = (kp >= 0) & (kp < limit) & torch.ones_like(rel, dtype=bool)
        if causal:
            mask = mask & (rel >= 0)
        if window > 0:
            mask = mask & (rel < window)
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrsc,bcgh->bgrsh", p, v[:, chunk].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def attend(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
           causal: bool = True, window: int = 0,
           cache: Optional[KVCache] = None, chunk_k: int = 1024
           ) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Projections, RoPE, the attention core and the output projection.

    With a cache, the new k/v land at ``cache.length`` (per row when it is
    a tensor, then one token per row; a write past the end lands on the
    last slot, as the reference's clamped update does)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.apply_rope((x @ p["wq"]).reshape(B, S, H, hd), positions,
                          cfg.rope_theta, cfg.mrope_sections)
    k = layers.apply_rope((x @ p["wk"]).reshape(B, S, K, hd), positions,
                          cfg.rope_theta, cfg.mrope_sections)
    v = (x @ p["wv"]).reshape(B, S, K, hd)

    new_cache = None
    in_context = cache is None
    if cache is not None:
        start, s_max = cache.length, cache.k.shape[1]
        k, v = k.to(cache.k.dtype), v.to(cache.v.dtype)
        if isinstance(start, torch.Tensor):
            if S != 1:
                raise ValueError("per-row cache lengths take one token per "
                                 f"row, got {S}")
            rows = torch.arange(B, device=x.device)
            slot = start.clamp(max=s_max - 1)
            cache.k[rows, slot] = k[:, 0]
            cache.v[rows, slot] = v[:, 0]
        else:
            if start + S > s_max:
                raise ValueError(f"cache of {s_max} cannot take {S} tokens "
                                 f"at {start}")
            cache.k[:, start:start + S] = k
            cache.v[:, start:start + S] = v
            in_context = start == 0       # fresh cache: attend the prompt
        new_cache = KVCache(cache.k, cache.v, start + S)

    if in_context:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = blockwise_attention(q, cache.k, cache.v, causal=causal,
                                  window=window, q_offset=cache.length,
                                  kv_len=cache.length + S, chunk_k=chunk_k)
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache
