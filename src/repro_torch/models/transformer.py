"""The dense decoder-only LM (TinyLlama and its kin).

The param tree is the reference's: ``emb``, ``final_norm``, ``lm_head``
(unless tied) and ``seg0``, whose leaves stack the layers on a leading
axis. The layers run in a Python loop over that axis, the reference's
serving build (``scan_layers=False``); a stacked layer cache is indexed
the same way, so a layer's cache update writes into the stack in place.
Other families (MoE, SSM, hybrid, enc-dec, gemma's local/global plan)
raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.device import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.attention import KVCache


class Segment(NamedTuple):
    kind: str
    count: int


def segment_plan(cfg) -> List[Segment]:
    if cfg.family != "dense" or cfg.moe.n_experts > 0 or cfg.global_every:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (moe experts "
            f"{cfg.moe.n_experts}, global_every {cfg.global_every}) is not "
            "ported yet; the port builds the dense family")
    return [Segment("dense", cfg.n_layers)]


def _block_init(gen, cfg, count: int, device) -> dict:
    stack = (count,)
    return {"ln1": layers.norm_init(cfg, device, stack),
            "attn": attention.attn_init(gen, cfg, device, stack),
            "ln2": layers.norm_init(cfg, device, stack),
            "mlp": layers.mlp_init(gen, cfg, device, stack)}


def init_params(cfg, gen: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random params at the config's widths, drawn on `device` from `gen`
    (default: a generator seeded with 0 there)."""
    device = resolve_device(device)
    if cfg.learned_pos_emb:
        raise NotImplementedError("learned position embeddings are not "
                                  "ported yet")
    plan = segment_plan(cfg)
    if gen is None:
        gen = torch.Generator(device=device).manual_seed(0)
    dtype = getattr(torch, cfg.dtype)
    shape = (cfg.padded_vocab, cfg.d_model)
    params = {"emb": layers.dense_init(gen, shape, dtype, device),
              "final_norm": layers.norm_init(cfg, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, shape, dtype, device)
    for i, seg in enumerate(plan):
        params[f"seg{i}"] = _block_init(gen, cfg, seg.count, device)
    return params


def _layer(tree, i: int):
    """Layer i of a stacked subtree (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_dense(x, p, cfg, *, positions, cache, chunk_k):
    h = layers.apply_norm(x, p["ln1"], cfg)
    a, new_cache = attention.attend(h, p["attn"], cfg, positions=positions,
                                    cache=cache, chunk_k=chunk_k)
    x = x + a
    h = layers.apply_norm(x, p["ln2"], cfg)
    return x + layers.apply_mlp(h, p["mlp"], cfg), new_cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of (B, S, V) fp32 logits."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - picked).mean()


class LanguageModel:
    """Dense decoder-only LM with unrolled layers (the serving build)."""

    def __init__(self, cfg, *, chunk_k: int = 1024, scan_layers: bool = False,
                 device="cuda"):
        if scan_layers:
            raise NotImplementedError(
                "the port runs its layers in a Python loop (the reference's "
                "scan_layers=False serving build); a scanned layer stack has "
                "no eager counterpart")
        self.cfg = cfg
        self.plan = segment_plan(cfg)
        self.chunk_k = chunk_k
        self.scan_layers = False
        self.device = resolve_device(device)

    def init(self, gen: Optional[torch.Generator] = None) -> dict:
        return init_params(self.cfg, gen, self.device)

    def param_count(self, params: dict) -> int:
        def count(t):
            if isinstance(t, dict):
                return sum(count(v) for v in t.values())
            return t.numel()
        return count(params)

    # -- embedding / head ----------------------------------------------------
    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = params["emb"][tokens.long()]
        root = torch.sqrt(torch.tensor(float(self.cfg.d_model),
                                       device=x.device))
        return x * root.to(x.dtype)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = layers.apply_norm(x, params["final_norm"], cfg)
        table = params.get("lm_head", params["emb"])
        logits = layers.softcap((x @ table.t()).float(), cfg.logit_softcap)
        if cfg.padded_vocab != cfg.vocab_size:
            logits[..., cfg.vocab_size:] = -1e30
        return logits

    def _layers(self, params, x, positions, caches):
        """Every layer in order; returns x and the new caches (None without
        caches), whose tensors every layer wrote in place."""
        new_caches = None if caches is None else {}
        for i, seg in enumerate(self.plan):
            key = f"seg{i}"
            c = None if caches is None else caches[key]
            for j in range(seg.count):
                lc = None if c is None else KVCache(c.k[j], c.v[j], c.length)
                x, _ = _apply_dense(x, _layer(params[key], j), self.cfg,
                                    positions=positions, cache=lc,
                                    chunk_k=self.chunk_k)
            if c is not None:
                new_caches[key] = KVCache(c.k, c.v, c.length + x.shape[1])
        return x, new_caches

    @staticmethod
    def _arange_positions(tokens: torch.Tensor, start=0) -> torch.Tensor:
        B, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)
        if isinstance(start, torch.Tensor):
            return start.reshape(B, 1) + pos
        return (pos + start).expand(B, S)

    # -- forward (no cache) ------------------------------------------------
    def forward(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (fp32 logits (B, S, V), aux loss 0)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, _ = self._layers(params, x, self._arange_positions(tokens), None)
        return (self._head(params, x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params, batch) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
        logits, aux = self.forward(params, batch)
        labels = batch.get("labels")
        if labels is None:
            labels = torch.nn.functional.pad(batch["tokens"][:, 1:], (0, 1))
        ce = cross_entropy(logits, labels)
        return ce + aux, {"ce": ce, "aux": aux}

    # -- serving -----------------------------------------------------------
    def init_cache(self, batch_size: int, s_max: int) -> dict:
        """Zeroed caches matching the segment plan, length 0."""
        cfg = self.cfg
        return {f"seg{i}": attention.init_kv_cache(
                    batch_size, s_max, cfg.n_kv_heads, cfg.head_dim,
                    getattr(torch, cfg.dtype), self.device, (seg.count,))
                for i, seg in enumerate(self.plan)}

    def prefill(self, params, batch, caches) -> Tuple[torch.Tensor, dict]:
        """Prompt pass into fresh caches (filled in place). batch:
        {"tokens": (B, S)}. Returns the last position's logits (B, 1, V)."""
        tokens = batch["tokens"]
        x = self._embed(params, tokens)
        x, caches = self._layers(params, x, self._arange_positions(tokens),
                                 caches)
        return self._head(params, x[:, -1:]), caches

    def decode_step(self, params, batch, caches) -> Tuple[torch.Tensor, dict]:
        """One token per row at the caches' length (an int, or a (B,)
        tensor of per-row lengths). Returns (logits (B, 1, V), caches)."""
        tokens = batch["tokens"]
        length = caches["seg0"].length
        x = self._embed(params, tokens)
        x, caches = self._layers(
            params, x, self._arange_positions(tokens, length), caches)
        return self._head(params, x), caches

