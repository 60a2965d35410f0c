"""Attention of the LMs: GQA with RoPE or M-RoPE and a KV cache, and
Whisper's cross-attention.

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

A sliding-window layer (gemma's local layers) decodes from a
``RingKVCache``: the window's W slots, slot s holding the token at the
position = s (mod W), each slot's absolute position in ``pos`` (-1:
empty). Its prefill attends the prompt in context through K7 with the
window mask, then fills the ring from the prompt's last W tokens; its
decode writes slot ``length % W`` and attends the ring masked by the
slots' positions (``blockwise_attention``'s ``k_positions``).

Cross-attention (``kv_override``: Whisper's decoder over the encoder's
per-layer k, v) takes the given (k, v) as they are: no rope on k, no
cache write, non-causal. Like a ring's, the call's length picks the core:
several queries (``forward``, the prefill) go to K7 (Sq != Sk), one query
(a decode step) to ``blockwise_attention`` over the cached keys, as
self-attention's decode does.

Caches are updated in place (the reference donates them; here the write
lands in the caller's tensors and the returned cache shares them).

Under a mesh whose "model" axis is larger than one (``tp``, a
``distributed/tensor_parallel.TP``) a forward without a cache takes the
layout the reference's branch order gives (``src/repro/models/
attention.py:226-241``): padded head-TP where ``pad_heads_to`` pads (no
cross-attention); otherwise head-TP where the model asks for it
(``head_tp``, the reference's rule: ``tensor_parallel.resolve_head_tp``);
otherwise kv-SP.

Head-TP: each rank projects its ``wq`` columns (H / tp heads), runs
K7 forward and K7b backward on the heads it attends, then its ``wo``
rows, and one all-reduce sums the ranks' partial outputs. k and v come
from the rank's ``wk`` / ``wv`` columns: its own kv heads where "model"
divides K, else the kv heads its q heads read, all-gathered from the
ranks' columns (an activation: MQA's single head). Padded head-TP
(``pad_heads_to``, where the reference pads: H not a multiple, no cache,
no cross-attention) attends H_pad / tp padded heads a rank, the zero heads
at the end of each group as the reference places them; where those are
not the heads the rank's ``wq`` block projects (an MHA such as
MiniCPM-2B's 36 heads over 2 ranks: rank 0 projects heads 0-17 but
attends padded heads 0-23), q (and, for an MHA, k and v) move between the
layouts before the core and the output moves back before ``wo``
(``tensor_parallel.reshard``); no padded head's value reaches the
output. Head-TP whose q heads do not divide over "model" (6 over 4: the
reference's GSPMD shards them unevenly) pads the core's heads to the
next multiple the same way, transiently (``_core_pad``), and drops the
padded outputs: the values are the unpadded ones.

kv-SP (``tensor_parallel.kv_sp_attention``): q's column blocks are
all-gathered to every head on every rank; k and v are projected as
head-TP's are, all-gathered to every kv head, and each rank keeps its
block of the sequence, [r ceil(S / tp), ...) (``TP.seq_block``; an
uneven split leaves the last blocks shorter: the all-gathers move
full-length tensors, so gloo's equal sizes hold, and the gradient of
each block returns through the move's all-reduce of a full-length
tensor, zero outside the block). K7 runs every head's queries over the
block with ``k_offset`` = the block's start (the causal and window masks
read key positions), the ranks' outputs merge by their log-sum-exps,
and each rank's ``wo`` rows read its own columns of the merged output.
Cross-attention under kv-SP takes ``tp_kv``'s block of the encoder's
frames, non-causal (no position enters its mask: offset 0). Decode,
prefill and ring caches are not run under a mesh (serving under a mesh
waits).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.distributed import tensor_parallel as tpm
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


class RingKVCache(NamedTuple):
    """A sliding-window layer's decode cache: k, v (..., B, W, K, hd), the
    window's W slots; ``pos`` (..., W) int32, each slot's absolute
    position (-1: empty); ``length`` the tokens seen, a host int shared by
    every row."""
    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor
    length: int


def init_ring_cache(batch: int, window: int, n_kv: int, head_dim: int,
                    dtype, device, stack: Tuple[int, ...] = ()
                    ) -> RingKVCache:
    shape = stack + (batch, window, n_kv, head_dim)
    return RingKVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device),
                       torch.full(stack + (window,), -1, dtype=torch.int32,
                                  device=device), 0)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int = 0,
                        q_offset: Length = 0,
                        kv_len: Optional[Length] = None,
                        k_positions: Optional[torch.Tensor] = None,
                        chunk_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv chunks of ``chunk_k`` keys.

    q (B, Sq, H, hd); k/v (B, Sk, K, hd), H % K == 0. ``q_offset`` is the
    absolute position of q[:, 0] and ``kv_len`` masks keys at and past it;
    each is an int or a (B,) tensor (one per row). ``k_positions`` (Sk,)
    gives each key's absolute position (a ring's slots; negative: empty),
    default its index. The last chunk is padded with masked zero keys, so
    every chunk has ``chunk_k`` keys.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), device=dev))
    qg = (q.float() * scale).reshape(B, Sq, K, rep, hd)

    n_chunks = max(-(-Sk // chunk_k), 1)
    pad = n_chunks * chunk_k - Sk
    k_pos = torch.full((n_chunks * chunk_k,), -1, dtype=torch.long,
                       device=dev)
    k_pos[:Sk] = (torch.arange(Sk, device=dev) if k_positions is None
                  else k_positions)
    if pad:
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


def _ring_prefill(cache: RingKVCache, k: torch.Tensor, v: torch.Tensor
                  ) -> RingKVCache:
    """A fresh ring filled from the prompt's k/v (B, S, K, hd) in place:
    for S >= W its last W tokens, rolled so that slot s holds the token
    at the position = s (mod W); for S < W the S tokens, then empty slots
    (zeros, position -1)."""
    if cache.length != 0:
        raise ValueError(f"a ring prefill takes a fresh cache, not one of "
                         f"length {cache.length}")
    S, W = k.shape[1], cache.k.shape[1]
    if S >= W:
        shift = S % W
        cache.k.copy_(torch.roll(k[:, S - W:], shift, dims=1))
        cache.v.copy_(torch.roll(v[:, S - W:], shift, dims=1))
        slots = torch.arange(W, device=k.device)
        cache.pos.copy_(S - W + (slots - S) % W)
    else:
        cache.k[:, :S] = k
        cache.v[:, :S] = v
        cache.k[:, S:] = 0
        cache.v[:, S:] = 0
        cache.pos.copy_(torch.cat([
            torch.arange(S, device=k.device),
            torch.full((W - S,), -1, device=k.device)]))
    return RingKVCache(cache.k, cache.v, cache.pos, S)


def _ring_decode(cache: RingKVCache, k: torch.Tensor, v: torch.Tensor
                 ) -> RingKVCache:
    """One token per row written at slot ``length % W``, in place."""
    slot = cache.length % cache.k.shape[1]
    cache.k[:, slot] = k[:, 0]
    cache.v[:, slot] = v[:, 0]
    cache.pos[slot] = cache.length
    return RingKVCache(cache.k, cache.v, cache.pos, cache.length + 1)


def pad_heads(t: torch.Tensor, target_groups_rep) -> torch.Tensor:
    """Zero-pad heads per GQA group: (B, S, H, hd) with H = K*rep ->
    (B, S, K*rep_pad, hd), keeping the q-head -> kv-head grouping. Padded
    heads are exact: a real head attends the same kv head as before and
    the padded heads' outputs are dropped."""
    K, rep, rep_pad = target_groups_rep
    B, S, H, hd = t.shape
    g = t.reshape(B, S, K, rep, hd)
    g = torch.nn.functional.pad(g, (0, 0, 0, rep_pad - rep))
    return g.reshape(B, S, K * rep_pad, hd)


def _pad_rep(H: int, K: int, pad_heads_to: int) -> Optional[tuple]:
    """The reference's padding of H heads to a multiple of
    `pad_heads_to` (its condition apart from the cache and
    cross-attention): (groups, rep, rep_pad), or None."""
    if not pad_heads_to or H % pad_heads_to == 0:
        return None
    H_pad = -(-H // pad_heads_to) * pad_heads_to
    if K == H:
        return (1, H, H_pad)
    if H_pad % K == 0:
        return (K, H // K, H_pad // K)
    return None


def _core_pad(H: int, K: int, tp_size: int) -> tuple:
    """Head-TP's transient padding of H q heads that do not divide over
    "model": MHA pads q, k and v to the next multiple of the axis; GQA
    pads each group's rep to the least rep_pad with K rep_pad a multiple
    of it (the grouping kept). (groups, rep, rep_pad)."""
    if K == H:
        return (1, H, -(-H // tp_size) * tp_size)
    rep = rep_pad = H // K
    while (K * rep_pad) % tp_size:
        rep_pad += 1
    return (K, rep, rep_pad)


def _tp_layout(cfg, tp, pad_rep):
    """The layout of one attention call under `tp`, by the reference's
    branch order: padded head-TP where `pad_rep` pads; head-TP where the
    model asks for it (its heads padded for the core where they do not
    divide over "model"); kv-SP otherwise."""
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    head_tp = tpm.resolve_head_tp(H, tp.head_tp)
    if pad_rep is None and head_tp and H % tp.size:
        pad_rep = _core_pad(H, K, tp.size)
    if pad_rep is not None or head_tp:
        return tpm.head_layout(H, K, hd, tp, pad_rep)
    return tpm.kv_sp_layout(H, K, hd, tp)


def _kv_block(lay, tp, n: int) -> Tuple[int, int]:
    """[start, stop) of the sequence's keys a rank attends: kv-SP's block
    (``TP.seq_block``), head-TP's whole sequence."""
    return (tp.seq_block(n) if isinstance(lay, tpm.KvSpLayout)
            else (0, n))


def tp_kv(src: torch.Tensor, p: dict, cfg, tp) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """Cross-attention's k, v under `tp`, from the rank's ``wk`` / ``wv``
    columns over the replicated `src` (the encoder's output): head-TP's
    kv heads the rank's q heads read, (B, Se, n_kv, hd) each, or kv-SP's
    block of the frames for every kv head, (B, Se_r, K, hd)."""
    lay = _tp_layout(cfg, tp, None)
    src = tpm.enter(src, tp, "cross.kv")
    return _tp_project_kv(src, p, cfg, tp, lay,
                          *_kv_block(lay, tp, src.shape[1]))


def _tp_project_kv(x, p, cfg, tp, lay, a: int, b: int):
    """k, v of `lay`'s kv heads (moved from the ranks' column blocks, or
    computed whole where the rules replicate the columns) at positions
    [a, b) of the sequence, (B, b - a, n_kv, hd) each: under kv-SP the
    move gathers the full sequence's columns and the rank keeps its block
    (gloo's all-gather needs equal sizes, so an uneven split moves
    full-length tensors, and each block's gradient returns through the
    move's all-reduce of a full-length one, zero outside the block)."""
    B = x.shape[0]
    wk, wv = p["wk"], p["wv"]
    tp.check_local(wk, cfg.kv_dim, -1, "wk")
    if not lay.kv_split:
        # the kv columns are replicated (the rules leave them so): each
        # rank computes them whole, for its own heads' part of the work
        wk, wv = tpm.enter(wk, tp, "attn.wk"), tpm.enter(wv, tp, "attn.wv")
    out = []
    for w, name in ((wk, "attn.k"), (wv, "attn.v")):
        t = tpm.reshard(x @ w, tp, lay.kv_move, name)[:, a:b]
        out.append(t.reshape(B, b - a, lay.n_kv, cfg.head_dim))
    return out[0], out[1]


def _attend_tp(x, p, cfg, tp, *, positions, causal, window, use_rope,
               kv_override, pad_heads_to):
    """``attend``'s forward without a cache under `tp` (see the module's
    docstring): head-TP's K7 on the rank's heads, or kv-SP's on every
    head over the rank's block of the keys, merged over "model"."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pad_rep = None if kv_override is not None else _pad_rep(H, K,
                                                           pad_heads_to)
    lay = _tp_layout(cfg, tp, pad_rep)
    tp.check_local(p["wq"], cfg.q_dim, -1, "wq")
    tp.check_local(p["wo"], cfg.q_dim, -2, "wo")
    x = tpm.enter(x, tp, "attn")
    q = tpm.reshard(x @ p["wq"], tp, lay.q_move, "attn.q")
    q = q.reshape(B, S, lay.n_q, hd)
    if use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta,
                              cfg.mrope_sections)
    if kv_override is not None:
        # cross-attention: no position enters its (non-causal) mask, so
        # kv-SP's block of the frames goes in at offset 0
        (k, v), a = kv_override, 0
        causal = False
    else:
        a, b = _kv_block(lay, tp, S)
        k, v = _tp_project_kv(x, p, cfg, tp, lay, a, b)
        if use_rope:
            k = layers.apply_rope(k, positions[..., a:b], cfg.rope_theta,
                                  cfg.mrope_sections)
    # K7 / K7b take contiguous inputs: a moved or padded tensor is a new
    # one (index_select), a rotated one too (apply_rope)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if isinstance(lay, tpm.KvSpLayout):
        out = tpm.kv_sp_attention(q, k, v, tp, causal=causal, window=window,
                                  k_offset=a)
    else:
        out = ops.flash_attention(q, k, v, causal=causal, window=window)
    out = tpm.reshard(out.reshape(B, S, lay.n_q * hd), tp, lay.out_move,
                      "attn.out")
    return tpm.leave(out @ p["wo"], tp, "attn.wo"), None


def attend(x: torch.Tensor, p: dict, cfg, *, positions: torch.Tensor,
           causal: bool = True, window: int = 0,
           cache: Optional[Union[KVCache, RingKVCache]] = None,
           chunk_k: int = 1024, use_rope: bool = True,
           kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           pad_heads_to: int = 0, tp=None
           ) -> Tuple[torch.Tensor, Optional[Union[KVCache, RingKVCache]]]:
    """Projections, RoPE (unless ``use_rope`` is off), the attention core
    and the output projection.

    With a KVCache, the new k/v land at ``cache.length`` (per row when it
    is a tensor, then one token per row; a write past the end lands on the
    last slot, as the reference's clamped update does). With a
    RingKVCache, S > 1 is a prefill into the fresh ring (attention over
    the prompt in context) and S == 1 a decode step against the ring.
    With ``kv_override`` = (k, v), (B, Sk, K, hd) each, the call is
    cross-attention over them (``cache`` is ignored): S > 1 through K7,
    S == 1 (a decode step) through the plain core. ``pad_heads_to``
    (``parallel.pad_attn_heads_to``) zero-pads the heads of a forward
    without a cache to a multiple of it, under the reference's condition
    (H not a multiple, no cross-attention): MHA pads q, k and v at the
    end, GQA each group's q heads; the padded heads' outputs are dropped,
    so the result is the unpadded one. Under `tp` (a mesh's "model" axis)
    the call is head-parallel or kv-SP (the module's docstring);
    `kv_override` is then ``tp_kv``'s."""
    if tp is not None:
        if cache is not None:
            raise NotImplementedError(
                "attention against a cache under a mesh: serving under a "
                "mesh is not ported (ROADMAP Queue 1 item 1)")
        return _attend_tp(x, p, cfg, tp, positions=positions, causal=causal,
                          window=window, use_rope=use_rope,
                          kv_override=kv_override,
                          pad_heads_to=pad_heads_to)
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    if use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta,
                              cfg.mrope_sections)
    if kv_override is not None:
        k, v = kv_override
        if S == 1:
            out = blockwise_attention(q, k, v, causal=False, chunk_k=chunk_k)
        else:
            out = ops.flash_attention(q, k, v, causal=False)
        return out.reshape(B, S, H * hd) @ p["wo"], None
    k = (x @ p["wk"]).reshape(B, S, K, hd)
    if use_rope:
        k = layers.apply_rope(k, positions, cfg.rope_theta,
                              cfg.mrope_sections)
    v = (x @ p["wv"]).reshape(B, S, K, hd)

    pad_rep = None if cache is not None else _pad_rep(H, K, pad_heads_to)
    if pad_rep is not None:
        if K == H:
            k, v = pad_heads(k, pad_rep), pad_heads(v, pad_rep)
        q = pad_heads(q, pad_rep)

    new_cache = None
    in_context = cache is None
    if isinstance(cache, RingKVCache):
        kc, vc = k.to(cache.k.dtype), v.to(cache.v.dtype)
        if S > 1:
            new_cache = _ring_prefill(cache, kc, vc)
            in_context = True
        else:
            new_cache = _ring_decode(cache, kc, vc)
            out = blockwise_attention(
                q, cache.k, cache.v, causal=causal, window=window,
                q_offset=cache.length, kv_len=cache.length + 1,
                k_positions=cache.pos, chunk_k=chunk_k)
            return out.reshape(B, S, H * hd) @ p["wo"], new_cache
    elif cache is not None:
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
        if pad_rep is not None:             # drop the padded q heads
            K_, rep, rep_pad = pad_rep
            out = out.reshape(B, S, K_, rep_pad, hd)[:, :, :, :rep]
    else:
        out = blockwise_attention(q, cache.k, cache.v, causal=causal,
                                  window=window, q_offset=cache.length,
                                  kv_len=cache.length + S, chunk_k=chunk_k)
    return out.reshape(B, S, H * hd) @ p["wo"], new_cache
