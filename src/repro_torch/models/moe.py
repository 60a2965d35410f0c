"""Mixture-of-Experts layer, the reference's ``repro.models.moe``.

Grouping, capacity and routing as the reference has them: capacity
selection happens per sequence (group = batch row); each expert keeps
``cap = min(max(int(S * k / E * cf), 1), S)`` tokens of its group, its
top-``cap`` by routed mass (the token's softmax probability where the
expert is among the token's top-k, else 0); overflow tokens drop that
expert. The router's logits and softmax are fp32; the three expert
products (``becd,edf->becf``) run in the model's dtype as batched
matmuls over the experts.

Ties. ``jax.lax.top_k`` puts the lower index first among equal values, and
in the expert's choice over (B, E, S) most entries are exact zeros (tokens
not routed to that expert), so ties are the rule. ``torch.topk`` promises
no order among ties; a stable descending sort sliced to the first k keeps
the reference's rule, for the token's top-k and for the expert's choice.

Determinism. Dispatch (a gather of the kept tokens into (B, E, C, D)) and
combine (their scatter-add back into (B, S, D)) are two autograd
Functions, the counterparts of the reference's ``custom_vjp`` pair: each
one's backward is the other's forward. The scatter-add sums, for each
token, the contributions of its own top-k experts that kept it, in
ascending expert order and in the values' dtype: the order and the
roundings of the reference's sequential scatter (the zero-gate slots an
expert fills its capacity with add exact zeros there, and are masked
here). No float atomics, so repeat runs and a CUDA graph's replay give
the same bits. Expert loads are counted by a scatter of ones into a fixed
(E,) buffer: nothing reads back to the host, so a step captures.

Expert-parallel under a mesh whose "model" axis is larger than one
(``tp``; the reference's ``moe.py:154-179``): the router stays
replicated, so routing and the aux loss are the same on every rank; a
rank runs its E / tp experts (the ``experts_*`` blocks it holds), its
capacity selection reads only its experts' gate columns, its combine sums
its experts' part of each token, and one all-reduce over "model" adds
the ranks' parts. The gate enters the region (its gradient, each rank's
own experts' columns, is summed over "model"), so the router's gradient
is whole on every rank. The shared expert is ``layers.apply_mlp``'s.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models import layers


def _check_act(cfg) -> None:
    if cfg.act != "silu":
        raise NotImplementedError(f"activation {cfg.act!r}: the port's "
                                  "experts are SwiGLU")


def moe_init(gen: torch.Generator, cfg, device,
             stack: Tuple[int, ...] = ()) -> dict:
    """The router in fp32, the experts in ``cfg.dtype``, and the shared
    expert's MLP where the config has one."""
    m = cfg.moe
    _check_act(cfg)
    dtype = getattr(torch, cfg.dtype)
    d, e, f = cfg.d_model, m.n_experts, m.expert_d_ff
    p = {"router": layers.dense_init(gen, stack + (d, e), torch.float32,
                                     device),
         "experts_in": layers.dense_init(gen, stack + (e, d, f), dtype,
                                         device),
         "experts_gate": layers.dense_init(gen, stack + (e, d, f), dtype,
                                           device),
         "experts_out": layers.dense_init(gen, stack + (e, f, d), dtype,
                                          device)}
    if m.n_shared_experts > 0:
        p["shared"] = layers.mlp_init(gen, cfg, device, stack,
                                      d_ff=m.shared_d_ff)
    return p


def capacity(seq_len: int, cfg) -> int:
    """Tokens each expert keeps per group, the reference's expression."""
    m = cfg.moe
    cap = max(int(seq_len * m.top_k / m.n_experts * m.capacity_factor), 1)
    return min(cap, seq_len)


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, the
    lower index first among equal ones. Values are gathered, so their
    gradient flows to `x`."""
    idx = torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]
    return torch.gather(x, -1, idx), idx


def aux_load_balance_loss(probs: torch.Tensor, top_i: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-Transformer load balancing loss (arXiv:2101.03961).
    probs (B, S, E) fp32, top_i (B, S, k); under a mesh's split batch its
    fractions are the whole batch's (``tensor_parallel.batch_mean``)."""
    ones = torch.ones(top_i.numel(), dtype=torch.float32,
                      device=probs.device)
    counts = torch.zeros(n_experts, dtype=torch.float32,
                         device=probs.device).scatter_add_(
                             0, top_i.reshape(-1), ones)
    # over the whole batch, as the reference's global batch (a rank's
    # rows under a mesh: the mean over the batch axes' shards)
    frac_tokens = tpm.batch_mean(counts / max(top_i.numel(), 1))
    frac_probs = tpm.batch_mean(probs.mean(dim=(0, 1)))
    return n_experts * torch.sum(frac_tokens * frac_probs)


class Routing:
    """Where each kept token sits, both ways.

    ``sel_idx`` (B, E, C): the token in slot (e, c); ``kept`` (B, E, C):
    the slot holds a token of that expert's top-k routing (its gate is
    not 0); ``flat`` (B, S, k): for each token and each of its top-k
    experts in ascending order, the flat slot e * C + c that kept it, or
    -1 where that expert dropped it. With `first` (expert-parallel) the E
    experts are the rank's, those from `first` on: a token's other
    experts are not kept here."""

    def __init__(self, sel_idx: torch.Tensor, kept: torch.Tensor,
                 top_i: torch.Tensor, first: Optional[int] = None):
        B, E, C = sel_idx.shape
        S = top_i.shape[1]
        dev = sel_idx.device
        slot_c = torch.arange(C, device=dev).expand(B, E, C)
        # the slot of (expert, token), -1 where not kept; the indices of a
        # row are distinct, so the scatter writes each entry at most once
        where = torch.full((B, E, S), -1, dtype=torch.long, device=dev)
        where.scatter_(2, sel_idx, torch.where(kept, slot_c, -1))
        cand = torch.sort(top_i, dim=-1)[0]                   # (B, S, k)
        rows = torch.arange(B, device=dev)[:, None, None]
        toks = torch.arange(S, device=dev)[None, :, None]
        if first is not None:
            cand = cand - first
            mine = (cand >= 0) & (cand < E)
            c = torch.where(mine, where[rows, cand.clamp(0, E - 1), toks],
                            -1)
        else:
            c = where[rows, cand, toks]
        self.sel_idx, self.kept = sel_idx, kept
        self.flat = torch.where(c >= 0, cand * C + c, -1)
        self.seq_len = S


def _gather(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """(B, S, D) -> (B, E, C, D): the kept tokens in their slots, zeros in
    the others."""
    B, E, C = r.sel_idx.shape
    D = x.shape[-1]
    idx = r.sel_idx.reshape(B, E * C, 1).expand(B, E * C, D)
    xe = torch.gather(x, 1, idx).reshape(B, E, C, D)
    return xe * r.kept[..., None].to(xe.dtype)


def _scatter_add(ye: torch.Tensor, r: Routing) -> torch.Tensor:
    """(B, E, C, D) -> (B, S, D): each token's kept slots summed from 0 in
    ascending expert order, in ye's dtype."""
    B, E, C, D = ye.shape
    S, k = r.seq_len, r.flat.shape[-1]
    flat = r.flat.clamp_min(0).reshape(B, S * k, 1).expand(B, S * k, D)
    parts = torch.gather(ye.reshape(B, E * C, D), 1, flat)
    parts = parts.reshape(B, S, k, D) * (r.flat >= 0)[..., None].to(ye.dtype)
    out = torch.zeros((B, S, D), dtype=ye.dtype, device=ye.device)
    for j in range(k):
        out = out + parts[:, :, j]
    return out


class _Dispatch(torch.autograd.Function):
    """Gather forward, ordered scatter-add backward."""

    @staticmethod
    def forward(ctx, x, routing):
        ctx.routing = routing
        return _gather(x, routing)

    @staticmethod
    def backward(ctx, g):
        return _scatter_add(g, ctx.routing), None


class _Combine(torch.autograd.Function):
    """Ordered scatter-add forward, gather backward."""

    @staticmethod
    def forward(ctx, ye, routing):
        ctx.routing = routing
        return _scatter_add(ye, routing)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.routing), None


def dispatch(x: torch.Tensor, routing: Routing) -> torch.Tensor:
    return _Dispatch.apply(x, routing)


def combine(ye: torch.Tensor, routing: Routing) -> torch.Tensor:
    return _Combine.apply(ye, routing)


def _experts(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("becd,edf->becf") as one batched matmul over the experts."""
    B, E, C, D = xe.shape
    h = torch.bmm(xe.transpose(0, 1).reshape(E, B * C, D), w)
    return h.reshape(E, B, C, -1).transpose(0, 1)


def route(x: torch.Tensor, p: dict, cfg,
          gen: Optional[torch.Generator] = None, tp=None):
    """The router: (probs (B, S, E) fp32, top_i (B, S, k), sel_gate
    (B, E, C) fp32, Routing). Router jitter applies only with a
    generator, as the reference's only with a key. Under `tp` the
    capacity selection runs on the rank's E / tp experts' gate columns:
    sel_gate and the Routing are theirs."""
    m = cfg.moe
    S = x.shape[1]
    logits = x.float() @ p["router"]
    if m.router_jitter and gen is not None:
        logits = logits + m.router_jitter * torch.randn(
            logits.shape, generator=gen, device=logits.device)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = top_k_stable(probs, m.top_k)                # (B, S, k)
    # routed mass per (token, expert): the probability where the expert is
    # among the token's top-k (distinct indices: no colliding writes)
    gate = torch.zeros_like(probs).scatter(-1, top_i, top_p)
    first = None
    if tp is not None:
        first = tp.block(m.n_experts)[0]
        gate = tp.narrow(tpm.enter(gate, tp, "moe.gate"))
    sel_gate, sel_idx = top_k_stable(gate.transpose(1, 2),
                                     capacity(S, cfg))        # (B, E, C)
    kept = sel_gate > 0.0
    sel_gate = torch.where(kept, sel_gate, 0.0)
    return probs, top_i, sel_gate, Routing(sel_idx, kept, top_i, first)


def apply_moe(x: torch.Tensor, p: dict, cfg,
              gen: Optional[torch.Generator] = None, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D) in x's dtype, fp32 aux loss). Under
    `tp` expert-parallel where "model" divides the experts (the module's
    docstring)."""
    m = cfg.moe
    _check_act(cfg)
    ep = tp if tp is not None and tp.check_local(
        p["experts_in"], m.n_experts, -3, "experts_in") else None
    probs, top_i, sel_gate, routing = route(x, p, cfg, gen, ep)
    aux = aux_load_balance_loss(probs, top_i, m.n_experts) * \
        m.aux_loss_weight
    xe = dispatch(x if ep is None else tpm.enter(x, ep, "moe"), routing)
    h = _experts(xe, p["experts_in"])
    g = _experts(xe, p["experts_gate"])
    ye = _experts(F.silu(g) * h, p["experts_out"])
    ye = ye * sel_gate[..., None].to(ye.dtype)
    out = combine(ye, routing)
    if ep is not None:
        out = tpm.leave(out, ep, "moe.combine")
    if "shared" in p:
        out = out + layers.apply_mlp(x, p["shared"], cfg, tp,
                                     m.shared_d_ff).to(out.dtype)
    return out.to(x.dtype), aux
