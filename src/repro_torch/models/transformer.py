"""The LMs: the dense family (TinyLlama, MiniCPM, Granite's plain GELU
MLP and one KV head, Gemma3's local/global plan), the VLM family
(Qwen2-VL: dense blocks under M-RoPE), the MoE family (Qwen3-30B-A3B:
every layer MoE; Llama4-Maverick: a dense layer then an MoE layer, 1:1),
the SSM family (Mamba2: Mamba-2 blocks), the hybrid family (Zamba2:
groups of Mamba-2 blocks, each group followed by ONE shared attention +
MLP block) and the enc-dec family (Whisper: a bidirectional encoder over
the stub frontend's frames, then decoder blocks with cross-attention).

The param tree is the reference's: ``emb``, ``final_norm``, ``lm_head``
(unless tied), ``pos_emb`` (max_seq_len, d) and ``enc_pos_emb``
(encoder_seq_len, d) (learned positions: enc-dec), ``shared_block``
(hybrid: a dense block stored once, outside the segments) and ``seg0``,
``seg1``, ..., whose leaves stack the layers on leading axes
(``param_stack_dims``: one stack axis under ``seg<i>``, two under a
``zamba`` super-block's ``mamba`` sub-stack and a ``gemma`` super-block's
``local`` sub-stack, none elsewhere; the DMD accelerator treats each layer
as its own system). The layers run in a Python loop
over those axes, the reference's unrolled build (``scan_layers=False``):
each stacked leaf is unbound once per call (a two-axis leaf over both of
its axes at once), so its gradient is one stack of the layers'
gradients, not one full-stack write per layer. A stacked layer cache is
indexed the same way, so a layer's cache update writes into the stack in
place.

Training: ``loss`` is differentiable end to end; attention's backward is
K7b on the card (``kernels/flash_attention.py``). ``remat="block"`` or
``"full"`` (the reference's ``jax.checkpoint`` of each super-block) keeps
only each super-block's input and recomputes it in the backward
(``torch.utils.checkpoint``, non-reentrant): the same values, bit for
bit, and K7 runs twice per attention layer.

The segment plan is the reference's: ``dense``, ``moe`` (attention, then
the MoE feed-forward of ``models/moe.py``), ``moe_pair`` (a dense layer
then an MoE layer, one stacked pair per step, with the cache pair
``{"dense", "moe"}``), ``mamba`` (one Mamba-2 block of ``models/ssm.py``,
its cache an ``SSMState``), ``zamba`` (``shared_attn_every`` Mamba-2
blocks then the shared block, with the cache ``{"mamba": stacked
SSMStates, "shared": the invocation's own KVCache}``; a depth that is not
a multiple of the group adds a ``mamba`` remainder segment), ``gemma``
(``global_every - 1`` sliding-window layers then one global layer, with
the cache ``{"local": stacked RingKVCaches, "global": a KVCache}``),
``dense_local`` (gemma's remainder of window layers, ring caches), ``enc``
(a dense block, non-causal, without rope) and ``dec`` (causal
self-attention without rope, cross-attention over per-layer k, v of the
encoder's output, the MLP; its cache ``{"self": a KVCache, "cross_k",
"cross_v"}``, two tensors). Each MoE layer's fp32 load-balancing loss is
summed over the layers in order; ``forward`` returns that sum as its aux
loss (0 without MoE layers) and ``loss`` is ce + aux, as the reference's.

Batches are the reference's: ``tokens`` (or the stub frontend's
``embeds``), ``positions`` where given ((B, S), or (B, 3, S) streams under
M-RoPE; else 0 ... S - 1, and in a decode step the cache length on; a
VLM's decode takes its positions from the batch) and ``frames`` (B,
encoder_seq_len, d) for the encoder. The encoder's output is not normed:
the reference applies no final norm there, and the port keeps that.

Under a mesh whose "model" axis is larger than one (``loss`` and
``forward`` called inside ``sharding.mesh_context``, as the train step
calls them on a rank's blocks) the model is tensor-parallel over
"model" (``distributed/tensor_parallel.py``): head-parallel attention
(``attention.attend``), column / row-parallel MLPs, expert-parallel MoE
layers, head-parallel SSM blocks, and a vocab-parallel embedding, head
and cross entropy (the rank's vocabulary rows; a vocabulary the rules
leave replicated is computed whole). Attention takes the reference's
layout: padded head-TP where ``pad_heads_to`` pads, else head-TP where
``head_tp``, else kv-SP (k and v split by sequence over "model", q
whole on every rank). ``head_tp`` is the reference's argument and is
resolved as the reference resolves it, at build time, from the literal
16, its production mesh's "model" size, not the live mesh's
(``transformer.py:402-404``): None means ``n_heads % 16 == 0``, and
``LanguageModel.head_tp`` holds the resolved bool. On one device it
changes no value. Serving (``prefill``, ``decode_step``) under such a
mesh is not ported.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.paths import tree_map
from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.kernels.device import resolve_device
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.attention import KVCache, RingKVCache
from repro_torch.models.ssm import SSMState


class Segment(NamedTuple):
    kind: str
    count: int


# the reference's families
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def segment_plan(cfg) -> List[Segment]:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}; the "
                         f"reference's families are {FAMILIES}")
    if cfg.family == "encdec":
        return [Segment("enc", cfg.n_encoder_layers),
                Segment("dec", cfg.n_layers)]
    if cfg.family == "ssm":
        return [Segment("mamba", cfg.n_layers)]
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, cfg.shared_attn_every)
        plan = [Segment("zamba", n_groups)]
        if rem:
            plan.append(Segment("mamba", rem))
        return plan
    if cfg.moe.n_experts > 0:
        if cfg.moe.moe_every == 1:
            return [Segment("moe", cfg.n_layers)]
        if cfg.moe.moe_every != 2:
            raise ValueError(f"moe_every {cfg.moe.moe_every}: the "
                             "reference's plans take 1 or 2")
        n_pairs, rem = divmod(cfg.n_layers, 2)
        plan = [Segment("moe_pair", n_pairs)]
        if rem:
            plan.append(Segment("dense", rem))
        return plan
    if cfg.global_every > 0:
        n_groups, rem = divmod(cfg.n_layers, cfg.global_every)
        plan = [Segment("gemma", n_groups)]
        if rem:
            plan.append(Segment("dense_local", rem))
        return plan
    return [Segment("dense", cfg.n_layers)]


def _block_init(gen, cfg, kind: str, stack: Tuple[int, ...], device
                ) -> dict:
    if kind == "moe_pair":
        return {"dense": _block_init(gen, cfg, "dense", stack, device),
                "moe": _block_init(gen, cfg, "moe", stack, device)}
    if kind == "mamba":
        return {"ln": layers.norm_init(cfg, device, stack),
                "ssm": ssm.ssm_init(gen, cfg, device, stack)}
    if kind == "zamba":
        return {"mamba": _block_init(gen, cfg, "mamba",
                                     stack + (cfg.shared_attn_every,),
                                     device)}
    if kind == "gemma":
        return {"local": _block_init(gen, cfg, "dense_local",
                                     stack + (cfg.global_every - 1,),
                                     device),
                "global": _block_init(gen, cfg, "dense", stack, device)}
    if kind == "dec":
        return {"ln1": layers.norm_init(cfg, device, stack),
                "self_attn": attention.attn_init(gen, cfg, device, stack),
                "ln_x": layers.norm_init(cfg, device, stack),
                "cross_attn": attention.attn_init(gen, cfg, device, stack),
                "ln2": layers.norm_init(cfg, device, stack),
                "mlp": layers.mlp_init(gen, cfg, device, stack)}
    ffn = ({"moe": moe.moe_init(gen, cfg, device, stack)} if kind == "moe"
           else {"mlp": layers.mlp_init(gen, cfg, device, stack)})
    return {"ln1": layers.norm_init(cfg, device, stack),
            "attn": attention.attn_init(gen, cfg, device, stack),
            "ln2": layers.norm_init(cfg, device, stack), **ffn}


def init_params(cfg, gen: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random params at the config's widths, drawn on `device` from `gen`
    (default: a generator seeded with 0 there). On the "meta" device only
    the shapes and dtypes are made."""
    device = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    plan = segment_plan(cfg)
    if gen is None and device.type != "meta":
        gen = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    shape = (cfg.padded_vocab, cfg.d_model)
    params = {"emb": layers.dense_init(gen, shape, dtype, device),
              "final_norm": layers.norm_init(cfg, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, shape, dtype, device)
    if cfg.learned_pos_emb:
        params["pos_emb"] = layers.dense_init(
            gen, (cfg.max_seq_len, cfg.d_model), dtype, device)
        if cfg.family == "encdec":
            params["enc_pos_emb"] = layers.dense_init(
                gen, (cfg.encoder_seq_len, cfg.d_model), dtype, device)
    if cfg.family == "hybrid":
        params["shared_block"] = _block_init(gen, cfg, "dense", (), device)
    for i, seg in enumerate(plan):
        params[f"seg{i}"] = _block_init(gen, cfg, seg.kind, (seg.count,),
                                        device)
    return params


def param_stack_dims(cfg, params: Optional[dict] = None) -> dict:
    """How many leading stack axes each leaf of ``init_params`` carries,
    as the reference's ``param_stack_dims`` derives it from the segment
    plan: 1 under every ``seg<i>`` (one system per layer), 2 under a
    ``zamba`` segment's ``mamba`` sub-stack (one system per Mamba layer)
    and a ``gemma`` segment's ``local`` sub-stack (one per local layer),
    0 elsewhere (``shared_block`` and the position tables are one system
    each)."""
    if params is None:
        params = init_params(cfg, device="meta")
    plan = segment_plan(cfg)

    def const(tree, n):
        if isinstance(tree, dict):
            return {k: const(v, n) for k, v in tree.items()}
        return n

    out = {}
    for key, sub in params.items():
        if key.startswith("seg") and key[3:].isdigit():
            kind = plan[int(key[3:])].kind
            if kind == "zamba":
                out[key] = {"mamba": const(sub["mamba"], 2)}
            elif kind == "gemma":
                out[key] = {"local": const(sub["local"], 2),
                            "global": const(sub["global"], 1)}
            else:
                out[key] = const(sub, 1)
        else:
            out[key] = const(sub, 0)
    return out


def _unbind(tree, count: int) -> List[dict]:
    """The `count` layers of a stacked subtree: each leaf unbound once (its
    backward stacks the layers' gradients in one write)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, count) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(count)]
    return list(torch.unbind(tree, 0))


def _apply_dense(x, p, cfg, *, positions, cache, chunk_k, window=0,
                 causal=True, use_rope=True, pad_heads_to=0, tp=None):
    h = layers.apply_norm(x, p["ln1"], cfg)
    a, new_cache = attention.attend(h, p["attn"], cfg, positions=positions,
                                    causal=causal, window=window,
                                    cache=cache, chunk_k=chunk_k,
                                    use_rope=use_rope,
                                    pad_heads_to=pad_heads_to, tp=tp)
    x = x + a
    h = layers.apply_norm(x, p["ln2"], cfg)
    return x + layers.apply_mlp(h, p["mlp"], cfg, tp), new_cache


def _apply_moe_block(x, p, cfg, *, positions, cache, chunk_k,
                     pad_heads_to=0, tp=None):
    """Attention, then the MoE feed-forward: (x, new cache, fp32 aux)."""
    h = layers.apply_norm(x, p["ln1"], cfg)
    a, new_cache = attention.attend(h, p["attn"], cfg, positions=positions,
                                    cache=cache, chunk_k=chunk_k,
                                    pad_heads_to=pad_heads_to, tp=tp)
    x = x + a
    h = layers.apply_norm(x, p["ln2"], cfg)
    f, aux = moe.apply_moe(h, p["moe"], cfg, tp=tp)
    return x + f, new_cache, aux


def _layer_cache(c, j: int):
    """Layer j's view of a stacked segment cache (a KVCache, a
    RingKVCache, an SSMState, or a dict of them: the moe_pair's {"dense",
    "moe"}, the zamba super-block's {"mamba", "shared"}, the gemma
    super-block's {"local", "global"}, the dec block's {"self", "cross_k",
    "cross_v"})."""
    if c is None:
        return None
    if isinstance(c, dict):
        return {k: _layer_cache(v, j) for k, v in c.items()}
    if isinstance(c, torch.Tensor):                 # a dec's cross k, v
        return c[j]
    if isinstance(c, SSMState):
        return SSMState(*(t[j] for t in c))
    if isinstance(c, RingKVCache):
        return RingKVCache(c.k[j], c.v[j], c.pos[j], c.length)
    return KVCache(c.k[j], c.v[j], c.length)


def _advance(c, n: int):
    """A stacked segment cache whose KV length moved on by n tokens (an
    SSMState and a dec's cross k, v have no length: they were written in
    place)."""
    if isinstance(c, dict):
        return {k: _advance(v, n) for k, v in c.items()}
    if isinstance(c, (SSMState, torch.Tensor)):
        return c
    if isinstance(c, RingKVCache):
        return RingKVCache(c.k, c.v, c.pos, c.length + n)
    return KVCache(c.k, c.v, c.length + n)


def _first_kv(node) -> Optional[Union[KVCache, RingKVCache]]:
    if isinstance(node, (KVCache, RingKVCache)):
        return node
    if isinstance(node, dict):
        for v in node.values():
            kv = _first_kv(v)
            if kv is not None:
                return kv
    return None


def cache_length(caches: dict):
    """The length of the first KVCache or RingKVCache in `caches` (the
    reference's ``_cache_length``): a host int, or a (B,) tensor of
    per-row lengths; 0 where there is none (the SSM family)."""
    kv = _first_kv(caches)
    return 0 if kv is None else kv.length


def _apply_dec(x, p, cfg, *, positions, cache, chunk_k, enc, tp=None):
    """Whisper's decoder block: causal self-attention without rope, then
    cross-attention over this layer's k, v of the encoder's output `enc`
    (written into the cache's ``cross_k`` / ``cross_v`` in a prefill), or,
    in a decode step (a cache and no `enc`), over the cached ones; then
    the MLP."""
    h = layers.apply_norm(x, p["ln1"], cfg)
    a, nsc = attention.attend(h, p["self_attn"], cfg, positions=positions,
                              cache=None if cache is None else cache["self"],
                              chunk_k=chunk_k, use_rope=False, tp=tp)
    x = x + a
    h = layers.apply_norm(x, p["ln_x"], cfg)
    if enc is None:
        kv = (cache["cross_k"], cache["cross_v"])
    elif tp is not None:
        kv = attention.tp_kv(enc, p["cross_attn"], cfg, tp)
    else:
        B, Se, _ = enc.shape
        K, hd = cfg.n_kv_heads, cfg.head_dim
        kv = ((enc @ p["cross_attn"]["wk"]).reshape(B, Se, K, hd),
              (enc @ p["cross_attn"]["wv"]).reshape(B, Se, K, hd))
        if cache is not None:
            cache["cross_k"].copy_(kv[0])
            cache["cross_v"].copy_(kv[1])
    a, _ = attention.attend(h, p["cross_attn"], cfg, positions=positions,
                            chunk_k=chunk_k, use_rope=False, kv_override=kv,
                            tp=tp)
    x = x + a
    h = layers.apply_norm(x, p["ln2"], cfg)
    x = x + layers.apply_mlp(h, p["mlp"], cfg, tp)
    return x, (None if cache is None else dict(cache, self=nsc))


def _apply_block(kind, x, p, cfg, *, positions, cache, chunk_k,
                 shared=None, enc=None, pad_heads_to=0, tp=None):
    """One super-block of the plan: (x, new cache, fp32 aux or None).
    `shared` is the hybrid family's shared block, `enc` the encoder's
    output a dec block attends. `pad_heads_to` reaches the attention of
    the dense, dense_local and MoE blocks, as in the reference. `tp` (a
    mesh's "model" axis) makes every layer tensor-parallel."""
    if kind == "enc":
        x, _ = _apply_dense(x, p, cfg, positions=positions, cache=None,
                            chunk_k=chunk_k, causal=False, use_rope=False,
                            tp=tp)
        return x, None, None
    if kind == "dec":
        x, nc = _apply_dec(x, p, cfg, positions=positions, cache=cache,
                           chunk_k=chunk_k, enc=enc, tp=tp)
        return x, nc, None
    if kind in ("dense", "dense_local"):
        window = cfg.sliding_window if kind == "dense_local" else 0
        x, nc = _apply_dense(x, p, cfg, positions=positions, cache=cache,
                             chunk_k=chunk_k, window=window,
                             pad_heads_to=pad_heads_to, tp=tp)
        return x, nc, None
    if kind == "gemma":
        lc = None if cache is None else cache["local"]
        for i, lp in enumerate(p["local"]):
            x, _ = _apply_dense(x, lp, cfg, positions=positions,
                                cache=_layer_cache(lc, i), chunk_k=chunk_k,
                                window=cfg.sliding_window, tp=tp)
        x, ngc = _apply_dense(x, p["global"], cfg, positions=positions,
                              cache=None if cache is None
                              else cache["global"], chunk_k=chunk_k, tp=tp)
        return x, (None if cache is None
                   else {"local": lc, "global": ngc}), None
    if kind == "moe":
        return _apply_moe_block(x, p, cfg, positions=positions, cache=cache,
                                chunk_k=chunk_k, pad_heads_to=pad_heads_to,
                                tp=tp)
    if kind == "mamba":
        y, ns = ssm.apply_ssm(layers.apply_norm(x, p["ln"], cfg), p["ssm"],
                              cfg, state=cache, tp=tp)
        return x + y, ns, None
    if kind == "zamba":
        mc = None if cache is None else cache["mamba"]
        for i, lp in enumerate(p["mamba"]):
            x, _, _ = _apply_block("mamba", x, lp, cfg, positions=positions,
                                   cache=_layer_cache(mc, i),
                                   chunk_k=chunk_k, tp=tp)
        x, nsc = _apply_dense(x, shared, cfg, positions=positions,
                              cache=None if cache is None
                              else cache["shared"], chunk_k=chunk_k, tp=tp)
        return x, (None if cache is None
                   else {"mamba": mc, "shared": nsc}), None
    dc = None if cache is None else cache["dense"]
    mc = None if cache is None else cache["moe"]
    x, ndc = _apply_dense(x, p["dense"], cfg, positions=positions,
                          cache=dc, chunk_k=chunk_k, tp=tp)
    x, nmc, aux = _apply_moe_block(x, p["moe"], cfg, positions=positions,
                                   cache=mc, chunk_k=chunk_k,
                                   pad_heads_to=pad_heads_to, tp=tp)
    return x, (None if cache is None else {"dense": ndc, "moe": nmc}), aux


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - picked


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of (B, S, V) fp32 logits."""
    return _nll(logits, labels).mean()


# tokens per pass of ``LanguageModel.loss``'s head: the fp32 logits of a
# pass and their gradient are HEAD_ROWS x vocab each (at Qwen3's 151,936
# classes 0.62 GB; a whole microbatch of 2 x 4096 tokens would be 5 GB,
# three such buffers in the backward)
HEAD_ROWS = 1024


REMAT = ("none", "block", "full")


class LanguageModel:
    """The LM of every family (dense, VLM, MoE, SSM, hybrid, enc-dec) with
    unrolled layers. `pad_heads_to` (``parallel.pad_attn_heads_to``) pads
    the attention heads of a forward without a cache, as the reference's
    does (``attention.attend``); the result is the same. `head_tp` is the
    reference's choice of attention layout under a mesh (True: head-TP;
    False: kv-SP; None: head-TP where the q heads are a multiple of 16,
    the reference's rule), stored resolved; on one device neither
    changes a value."""

    def __init__(self, cfg, *, head_tp: Optional[bool] = None,
                 chunk_k: int = 1024, remat: str = "none",
                 scan_layers: bool = False, device="cuda",
                 pad_heads_to: int = 0):
        if scan_layers:
            raise NotImplementedError(
                "the port runs its layers in a Python loop (the reference's "
                "scan_layers=False build); a scanned layer stack has no "
                "eager counterpart")
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r} is not one of {REMAT}")
        self.cfg = cfg
        self.plan = segment_plan(cfg)
        self.chunk_k = chunk_k
        self.pad_heads_to = pad_heads_to
        self.head_tp = tpm.resolve_head_tp(cfg.n_heads, head_tp)
        self.remat = remat
        self.scan_layers = False
        self.device = resolve_device(device)

    def init(self, gen: Optional[torch.Generator] = None) -> dict:
        return init_params(self.cfg, gen, self.device)

    def param_stack_dims(self, params: Optional[dict] = None) -> dict:
        """Stack axes per leaf (see the module-level function)."""
        return param_stack_dims(self.cfg, params)

    def param_count(self, params: dict) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()
        return count(params)

    # -- embedding / head ----------------------------------------------------
    def _tp(self):
        """The ambient mesh's "model" axis (None: compute as on one
        device)."""
        return tpm.current(self.head_tp)

    def _vocab_split(self, table, tp) -> bool:
        return tp is not None and tp.check_local(
            table, self.cfg.padded_vocab, 0, "the vocabulary table")

    def _embed(self, params, batch, length=None, tp=None) -> torch.Tensor:
        """The batch's ``embeds`` (the stub frontend's) in the model's
        dtype, else its tokens' rows scaled by sqrt(d); with learned
        positions plus their rows: the batch's ``positions`` (stream 0 of
        (B, 3, S)) or 0 ... S - 1, and in a decode step (`length`, the
        cache's) the rows at (length + i) % max_seq_len, as the
        reference's ``_embed_decode``. Under `tp` the rows come from the
        rank's vocabulary block (vocab-parallel), the same values."""
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(getattr(torch, cfg.dtype))
        elif self._vocab_split(params["emb"], tp):
            x = tpm.vocab_embed(batch["tokens"], params["emb"], tp)
            root = torch.sqrt(torch.tensor(float(cfg.d_model)))
            x = x * root.to(x.dtype)
        else:
            # F.embedding: its backward on the card sums the rows of
            # repeated tokens in a fixed order (no float atomics), so a
            # graphed step equals the eager one bit for bit
            x = F.embedding(batch["tokens"].long(), params["emb"])
            # sqrt(d) in fp32, rounded to x's dtype, as the reference
            # scales; a host scalar, so a CUDA graph capture copies
            # nothing to the card
            root = torch.sqrt(torch.tensor(float(cfg.d_model)))
            x = x * root.to(x.dtype)
        if not cfg.learned_pos_emb:
            return x
        if length is not None:
            pos = self._arange_positions(x, length) % cfg.max_seq_len
        else:
            pos = batch.get("positions")
            if pos is None:
                pos = torch.arange(x.shape[1], device=x.device)[None]
            elif pos.dim() == 3:
                pos = pos[:, 0]
        return x + F.embedding(pos.long(), params["pos_emb"]).to(x.dtype)

    def _head(self, params, x: torch.Tensor, tp=None) -> torch.Tensor:
        """fp32 logits; under `tp` with the vocabulary split, the rank's
        vocabulary block of them (``tensor_parallel.vocab_logits``)."""
        cfg = self.cfg
        x = layers.apply_norm(x, params["final_norm"], cfg)
        table = params.get("lm_head", params["emb"])
        if self._vocab_split(table, tp):
            return tpm.vocab_logits(x, table, tp, softcap=cfg.logit_softcap,
                                    vocab_size=cfg.vocab_size)
        logits = layers.softcap((x @ table.t()).float(), cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    def _layer_fn(self, kind, x, p, positions, shared, enc, tp=None):
        x, _, aux = _apply_block(kind, x, p, self.cfg, positions=positions,
                                 cache=None, chunk_k=self.chunk_k,
                                 shared=shared, enc=enc,
                                 pad_heads_to=self.pad_heads_to, tp=tp)
        return x if aux is None else (x, aux)

    def _blocks(self, params, i: int, seg) -> list:
        """Segment i's super-blocks, unbound. A zamba block is {"mamba":
        its k Mamba layers}, a gemma block {"local": its k local layers,
        "global": its global layer}: the (groups, k, ...) leaves are
        unbound once over both axes, as (groups * k, ...) views."""
        sub = params[f"seg{i}"]
        if seg.kind not in ("zamba", "gemma"):
            return _unbind(sub, seg.count)
        name = "mamba" if seg.kind == "zamba" else "local"
        k = (self.cfg.shared_attn_every if seg.kind == "zamba"
             else self.cfg.global_every - 1)
        flat = _unbind(tree_map(lambda t: t.flatten(0, 1), sub[name]),
                       seg.count * k)
        blocks = [{name: flat[g * k:(g + 1) * k]} for g in range(seg.count)]
        if seg.kind == "gemma":
            for b, glob in zip(blocks, _unbind(sub["global"], seg.count)):
                b["global"] = glob
        return blocks

    def _remat(self, caches) -> bool:
        return (self.remat != "none" and caches is None
                and torch.is_grad_enabled())

    def _layers(self, params, x, positions, caches, enc=None, tp=None):
        """Every layer in order (the ``enc`` segment apart: ``_encode``
        runs it); returns x, the new caches (None without caches), whose
        tensors every layer wrote in place, and the fp32 sum of the MoE
        layers' aux losses (None without MoE layers). `enc` is the
        encoder's output the dec blocks attend (None in a decode step).
        Without caches and with ``remat`` on, each super-block is
        checkpointed while autograd records."""
        new_caches = None if caches is None else {}
        remat = self._remat(caches)
        shared = params.get("shared_block")
        aux_total = None
        for i, seg in enumerate(self.plan):
            if seg.kind == "enc":
                continue
            key = f"seg{i}"
            c = None if caches is None else caches[key]
            for j, lp in enumerate(self._blocks(params, i, seg)):
                if remat:
                    out = checkpoint(self._layer_fn, seg.kind, x, lp,
                                     positions, shared, enc, tp,
                                     use_reentrant=False,
                                     context_fn=tpm.recompute_context())
                    x, aux = out if isinstance(out, tuple) else (out, None)
                else:
                    x, _, aux = _apply_block(
                        seg.kind, x, lp, self.cfg, positions=positions,
                        cache=_layer_cache(c, j), chunk_k=self.chunk_k,
                        shared=shared, enc=enc,
                        pad_heads_to=self.pad_heads_to, tp=tp)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
            if c is not None:
                new_caches[key] = _advance(c, x.shape[1])
        return x, new_caches, aux_total

    @staticmethod
    def _arange_positions(x: torch.Tensor, start=0) -> torch.Tensor:
        """(B, S) positions start ... start + S - 1 of the (B, S, ...)
        `x`; `start` an int or a (B,) tensor of per-row starts."""
        B, S = x.shape[:2]
        pos = torch.arange(S, device=x.device)
        if isinstance(start, torch.Tensor):
            return start.reshape(B, 1) + pos
        return (pos + start).expand(B, S)

    def _positions(self, batch, x, length=0) -> torch.Tensor:
        """The batch's ``positions``, else `length` ... `length` + S - 1
        per row, broadcast to the (B, 3, S) streams under M-RoPE (the
        reference's ``_positions``)."""
        if "positions" in batch:
            return batch["positions"]
        pos = self._arange_positions(x, length)
        if self.cfg.mrope_sections:
            pos = pos[:, None, :].expand(x.shape[0], 3, x.shape[1])
        return pos

    def _encode(self, params, batch, tp=None) -> Optional[torch.Tensor]:
        """The enc-dec family's encoder over ``batch["frames"]`` (B, Se,
        d), in the model's dtype plus ``enc_pos_emb``'s first Se rows:
        the ``enc`` blocks, non-causal and without rope, each
        checkpointed under remat as the decoder's are. Its output is not
        normed (the reference's ``_encode`` applies no final norm). None
        for the other families."""
        if self.cfg.family != "encdec":
            return None
        x = batch["frames"].to(getattr(torch, self.cfg.dtype))
        x = x + params["enc_pos_emb"][None, :x.shape[1]].to(x.dtype)
        pos = self._arange_positions(x)
        remat = self._remat(None)
        for lp in self._blocks(params, 0, self.plan[0]):
            if remat:
                x = checkpoint(self._layer_fn, "enc", x, lp, pos, None, None,
                               tp, use_reentrant=False,
                               context_fn=tpm.recompute_context())
            else:
                x, _, _ = _apply_block("enc", x, lp, self.cfg, positions=pos,
                                       cache=None, chunk_k=self.chunk_k,
                                       tp=tp)
        return x

    # -- forward (no cache) ------------------------------------------------
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (fp32 logits (B, S, V), the fp32 aux loss summed over
        the MoE layers; 0 without them). Under a mesh's "model" axis the
        ranks' vocabulary blocks of the logits are gathered."""
        tp = self._tp()
        enc = self._encode(params, batch, tp)
        x = self._embed(params, batch, tp=tp)
        x, _, aux = self._layers(params, x, self._positions(batch, x), None,
                                 enc, tp)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        logits = self._head(params, x, tp)
        if logits.shape[-1] != self.cfg.padded_vocab:
            logits = tpm.gather_vocab(logits, tp)
        return logits, aux

    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        """(ce + aux, {"ce", "aux"}), the reference's ``loss``. The head
        and the cross entropy run HEAD_ROWS tokens at a time (each pass
        checkpointed while autograd records: its logits are recomputed in
        the backward), so no microbatch-sized fp32 logits exist; the mean
        is the sum of the passes' sums over the token count (one pass:
        the mean itself)."""
        labels = batch.get("labels")
        if labels is None:
            labels = torch.nn.functional.pad(batch["tokens"][:, 1:], (0, 1))
        tp = self._tp()
        enc = self._encode(params, batch, tp)
        x = self._embed(params, batch, tp=tp)
        x, _, aux = self._layers(params, x, self._positions(batch, x), None,
                                 enc, tp)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x, labels = x.reshape(1, -1, x.shape[-1]), labels.reshape(1, -1)
        n = labels.shape[1]
        if n <= HEAD_ROWS:
            ce = self._nll(params, x, labels, tp).mean()
            return ce + aux, {"ce": ce, "aux": aux}
        total = None
        for a in range(0, n, HEAD_ROWS):
            xs, ls = x[:, a:a + HEAD_ROWS], labels[:, a:a + HEAD_ROWS]
            if torch.is_grad_enabled():
                part = checkpoint(self._ce_sum, params, xs, ls, tp,
                                  use_reentrant=False,
                                  context_fn=tpm.recompute_context())
            else:
                part = self._ce_sum(params, xs, ls, tp)
            total = part if total is None else total + part
        ce = total / n
        return ce + aux, {"ce": ce, "aux": aux}

    def _nll(self, params, x, labels, tp=None):
        """Per-token cross entropy through the head (vocab-parallel where
        `tp` splits the vocabulary)."""
        logits = self._head(params, x, tp)
        if logits.shape[-1] != self.cfg.padded_vocab:
            return tpm.vocab_nll(logits, labels, tp)
        return _nll(logits, labels)

    def _ce_sum(self, params, x, labels, tp=None):
        """The summed cross entropy of a pass of tokens through the
        head."""
        return self._nll(params, x, labels, tp).sum()

    # -- serving -----------------------------------------------------------
    def _refuse_mesh(self) -> None:
        if self._tp() is not None:
            raise NotImplementedError(
                "prefill / decode under a mesh's 'model' axis: serving "
                "under a mesh is not ported (ROADMAP Queue 1 item 1)")

    def init_cache(self, batch_size: int, s_max: int) -> dict:
        """Zeroed caches matching the segment plan, length 0: a stacked
        KVCache per ``dense`` or ``moe`` segment, the pair ``{"dense",
        "moe"}`` of them per ``moe_pair`` segment, a stacked SSMState per
        ``mamba`` segment, ``{"mamba": SSMStates stacked (groups,
        shared_attn_every), "shared": a KVCache per group}`` per ``zamba``
        segment, ``{"local": RingKVCaches of the window stacked (groups,
        global_every - 1), "global": a KVCache per group}`` per ``gemma``
        segment, a stacked RingKVCache per ``dense_local`` segment and
        ``{"self": a KVCache, "cross_k", "cross_v": (layers, B,
        encoder_seq_len, K, hd) each}`` per ``dec`` segment (two tensors:
        the reference hands one zeros array to both, which the port's
        in-place writes cannot share); none for the ``enc`` segment."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.dtype)

        def full(stack):
            return attention.init_kv_cache(
                batch_size, s_max, cfg.n_kv_heads, cfg.head_dim, dtype,
                self.device, stack)

        def ring(stack):
            return attention.init_ring_cache(
                batch_size, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim,
                dtype, self.device, stack)

        def state(stack):
            return ssm.init_ssm_state(batch_size, cfg, dtype, self.device,
                                      stack)
        def cross(stack):
            return torch.zeros(stack + (batch_size, cfg.encoder_seq_len,
                                        cfg.n_kv_heads, cfg.head_dim),
                               dtype=dtype, device=self.device)
        caches = {}
        for i, seg in enumerate(self.plan):
            n = (seg.count,)
            if seg.kind == "enc":
                continue
            if seg.kind == "dec":
                caches[f"seg{i}"] = {"self": full(n), "cross_k": cross(n),
                                     "cross_v": cross(n)}
            elif seg.kind == "moe_pair":
                caches[f"seg{i}"] = {"dense": full(n), "moe": full(n)}
            elif seg.kind == "mamba":
                caches[f"seg{i}"] = state(n)
            elif seg.kind == "zamba":
                caches[f"seg{i}"] = {
                    "mamba": state(n + (cfg.shared_attn_every,)),
                    "shared": full(n)}
            elif seg.kind == "gemma":
                caches[f"seg{i}"] = {
                    "local": ring(n + (cfg.global_every - 1,)),
                    "global": full(n)}
            elif seg.kind == "dense_local":
                caches[f"seg{i}"] = ring(n)
            else:
                caches[f"seg{i}"] = full(n)
        return caches

    def prefill(self, params, batch, caches) -> Tuple[torch.Tensor, dict]:
        """Prompt pass into fresh caches (filled in place). batch:
        {"tokens": (B, S)}, with ``positions`` (a VLM's streams) and
        ``frames`` (enc-dec: the encoder runs here, and each dec layer's
        cross k, v land in its cache). Returns the last position's logits
        (B, 1, V)."""
        self._refuse_mesh()
        enc = self._encode(params, batch)
        x = self._embed(params, batch)
        x, caches, _ = self._layers(params, x, self._positions(batch, x),
                                    caches, enc)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, batch, caches) -> Tuple[torch.Tensor, dict]:
        """One token per row at the caches' length (an int, or a (B,)
        tensor of per-row lengths); at the batch's ``positions`` where
        given (a VLM's streams continue from its image grid, not from the
        cache's length). Returns (logits (B, 1, V), caches)."""
        self._refuse_mesh()
        length = cache_length(caches)
        x = self._embed(params, batch, length)
        x, caches, _ = self._layers(params, x,
                                    self._positions(batch, x, length), caches)
        return self._head(params, x), caches



def make_model(cfg, **kw) -> LanguageModel:
    return LanguageModel(cfg, **kw)
