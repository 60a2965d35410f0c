"""Tensor-parallel compute over the mesh's "model" axis: the building
blocks the models run on a rank's "model" block of each param.

The reference shards its compute over "model" by constraining the
activations' shardings (``src/repro/models/attention.py:226-306``,
``layers.py:144-146``, ``moe.py:154-179``, ``ssm.py:168-208``,
``transformer.py:459-471``) and lets GSPMD insert the collectives. Here
each rank computes on its own blocks and the collectives are explicit,
the Megatron pattern, each an autograd Function over the mesh's "model"
group:

  * ``enter``: a parallel region begins (identity forward, all-reduce of
    the gradient backward): the replicated input of column-parallel
    products, and a replicated param that each rank reads on its own part
    of the work (the SSM's ``norm_scale``, ``in_proj/B|C``,
    ``conv_w/B|C``), whose gradient is thereby summed over "model";
  * ``leave``: a row-parallel product ends (all-reduce forward, identity
    backward): its partial sums, the vocab-parallel embedding's rows;
  * ``psum``: a sum whose every consumer is itself partial (all-reduce
    both ways): the SSM's gated norm's sum of squares over ``d_inner``;
  * ``reshard``: features moved between two layouts of the ranks, the
    projection's head blocks and the padded heads a rank attends (one
    all-gather of the rank's block forward, one all-reduce backward;
    gloo has no all-to-all), and k / v heads a rank needs but does not
    project (MQA's single head); a purely local selection where no rank
    needs another's features, and the identity where the layouts agree;
  * ``vocab_embed`` / ``vocab_nll``: the embedding lookup on a rank's
    vocabulary rows (zeros elsewhere, one all-reduce) and the
    log-softmax cross entropy over the vocabulary's blocks (max, sum of
    exponentials and the target's logit over "model");
  * ``kv_sp_attention``: kv-SP's core, the reference's third attention
    layout (``src/repro/models/attention.py:6-15``): every rank attends
    every head's queries over its own block of the keys (K7 with the
    block's key offset), and the blocks' results merge by their
    log-sum-exps, one all-reduce of the max and one of the weighted fp32
    outputs and weights (the reference's "two small all-reduces");
    backward, dO is summed over "model" (each rank's ``wo`` rows saw its
    own columns of the output) and K7b runs on the merged output and
    log-sum-exp, so dK and dV come out whole for the rank's keys and dQ
    as its part of a sum that the q move's backward completes.

Each collective goes through ``launch/mesh.py``'s ``Mesh``, recorded
with its site as ``what``. ``TP`` is the "model" axis of a live mesh;
``current()`` is None without a mesh or at "model" size 1, and then the
models run exactly their one-device code.

A statistic over the whole batch (the MoE layers' load-balancing loss,
which the reference computes over its global batch) is averaged over the
batch axes the rows were split over (``batch_mean``, inside the train
step's ``batch_split``); a checkpointed block recomputes inside the same
contexts (``recompute_context``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.distributed.sharding import current_mesh, mesh_context

AXIS = "model"
# the mask value of padded vocabulary rows (the reference's)
NEG_INF = -1e30


# the reference decides head-TP at build time against its production
# mesh's "model" size (``src/repro/models/transformer.py:402-404``), not
# the live mesh's: head-TP where the q heads are a multiple of it
HEAD_TP_DEGREE = 16


def resolve_head_tp(n_heads: int, head_tp: Optional[bool]) -> bool:
    """The reference's choice of attention layout: `head_tp` where given,
    else head-TP where `n_heads` is a multiple of HEAD_TP_DEGREE (kv-SP
    otherwise)."""
    return n_heads % HEAD_TP_DEGREE == 0 if head_tp is None else head_tp


class TP:
    """The "model" axis of `mesh` as the models see it: its size, this
    rank's index on it, and the model's ``head_tp`` choice (None: the
    reference's rule, ``resolve_head_tp``)."""

    def __init__(self, mesh, head_tp: Optional[bool] = None):
        self.mesh = mesh
        self.size = mesh.axis_size(AXIS)
        self.index = mesh.axis_index(AXIS)
        self.head_tp = head_tp

    def splits(self, n: int) -> bool:
        """A dim of `n` is split over "model" (the sharding rules' test:
        a dim the axis does not divide stays replicated)."""
        return n % self.size == 0

    def block(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's block of a split dim of `n`."""
        b = n // self.size
        return self.index * b, (self.index + 1) * b

    def narrow(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of a replicated tensor along `dim`."""
        a, b = self.block(t.shape[dim])
        return t.narrow(dim, a, b - a)

    def seq_block(self, n: int) -> Tuple[int, int]:
        """[start, stop) of this rank's block of a sequence of `n` under
        kv-SP: blocks of ceil(n / size), the last ones shorter (or empty)
        where the axis does not divide `n`."""
        b = -(-n // self.size)
        return min(self.index * b, n), min((self.index + 1) * b, n)

    def check_local(self, t: torch.Tensor, full: int, dim: int,
                    what: str) -> bool:
        """Whether `t` (a param as the rank holds it) is split along `dim`
        from `full`; raises where its size is neither."""
        n = t.shape[dim]
        if self.splits(full) and n == full // self.size:
            return True
        if n == full and not self.splits(full):
            return False
        raise ValueError(f"{what}: a rank holds {n} of {full} along dim "
                         f"{dim} under a 'model' axis of {self.size}")


def current(head_tp: Optional[bool] = None) -> Optional[TP]:
    """The TP of the ambient mesh (``sharding.mesh_context``); None
    without one or where its "model" axis is 1."""
    mesh = current_mesh()
    if mesh is None or mesh.axis_size(AXIS) == 1:
        return None
    return TP(mesh, head_tp)


# ---------------------------------------------------------------------------
# The region's collectives
# ---------------------------------------------------------------------------

def _all_reduce(t: torch.Tensor, tp: TP, what: str,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = t.contiguous().clone()
    tp.mesh.all_reduce(out, AXIS, op=op, what=what)
    return out


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, what):
        ctx.tp, ctx.what = tp, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp, ctx.what), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, what):
        return _all_reduce(x, tp, what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, what):
        ctx.tp, ctx.what = tp, what
        return _all_reduce(x, tp, what)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp, ctx.what), None, None


def enter(x: torch.Tensor, tp: TP, what: str) -> torch.Tensor:
    """Identity forward; the gradient all-reduced over "model"."""
    return _Enter.apply(x, tp, what)


def leave(x: torch.Tensor, tp: TP, what: str) -> torch.Tensor:
    """All-reduced over "model" forward; the gradient as it is."""
    return _Leave.apply(x, tp, what)


def psum(x: torch.Tensor, tp: TP, what: str) -> torch.Tensor:
    """All-reduced over "model" forward and backward."""
    return _Psum.apply(x, tp, what)


# ---------------------------------------------------------------------------
# Statistics over the batch axes
# ---------------------------------------------------------------------------

_BATCH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_batch_split", default=None)


@contextlib.contextmanager
def batch_split(mesh, axes):
    """Inside the block a rank's rows are its share of the batch, split
    over `axes` of `mesh` (none: the batch is whole on every rank)."""
    token = _BATCH.set((mesh, tuple(axes)) if axes else None)
    try:
        yield
    finally:
        _BATCH.reset(token)


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        out = x.contiguous().clone()
        mesh.all_reduce(out, axes, what="batch_mean")
        return out / mesh.axis_size(axes)

    @staticmethod
    def backward(ctx, g):
        out = g.contiguous().clone()
        ctx.mesh.all_reduce(out, ctx.axes, what="batch_mean")
        return out / ctx.mesh.axis_size(ctx.axes), None, None


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of a per-rank statistic of equal-sized row shards over the
    batch axes (all-reduced both ways: each rank's gradient is then the
    one that the train step's mean over the batch axes makes right); `x`
    itself where the batch is not split."""
    split = _BATCH.get()
    if split is None:
        return x
    return _BatchMean.apply(x, *split)


@contextlib.contextmanager
def _within(mesh, split):
    with mesh_context(mesh), batch_split(*(split or (None, ()))):
        yield


def recompute_context():
    """A ``torch.utils.checkpoint`` ``context_fn``: the block's
    recomputation in the backward (on whichever thread runs it) enters
    the mesh and batch contexts of its forward."""
    mesh, split = current_mesh(), _BATCH.get()
    return lambda: (contextlib.nullcontext(), _within(mesh, split))


# ---------------------------------------------------------------------------
# Moving features between layouts
# ---------------------------------------------------------------------------

class Move:
    """A move of the last dim's features from one layout of the ranks to
    another: ``have[r]`` the feature ids rank r holds (in order; -1 an
    unused slot), ``want[r]`` the ids it needs (-1: a zero feature).
    ``kind`` is "same" (every rank needs what it holds, in order),
    "local" (every rank needs only features it holds) or "gather"."""

    def __init__(self, have: Sequence[np.ndarray], want: Sequence[np.ndarray]):
        self.have = [np.asarray(h, np.int64) for h in have]
        self.want = [np.asarray(w, np.int64) for w in want]
        n = {len(h) for h in self.have}
        if len(n) != 1:
            raise ValueError(f"every rank must hold as many features: {n}")
        self.width = n.pop()
        if all(len(h) == len(w) and (h == w).all()
               for h, w in zip(self.have, self.want)):
            self.kind = "same"
        elif all(np.isin(w[w >= 0], h).all()
                 for h, w in zip(self.have, self.want)):
            self.kind = "local"
        else:
            self.kind = "gather"
        self._pos: Dict[Tuple[int, str], torch.Tensor] = {}

    def positions(self, rank: int, device) -> torch.Tensor:
        """Where each wanted feature of `rank` sits in the source (its own
        block, or the gathered blocks in rank order); a zero feature sits
        past the end."""
        key = (rank, str(device))
        if key not in self._pos:
            src = (self.have[rank] if self.kind == "local"
                   else np.concatenate(self.have))
            first: Dict[int, int] = {}
            for i, f in enumerate(src.tolist()):
                if f >= 0:
                    first.setdefault(f, i)
            pos = [first[f] if f >= 0 else len(src)
                   for f in self.want[rank].tolist()]
            self._pos[key] = torch.tensor(pos, dtype=torch.long,
                                          device=device)
        return self._pos[key]


class _Reshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, move, what):
        ctx.tp, ctx.move, ctx.what = tp, move, what
        if move.kind == "gather":
            src = torch.cat(tp.mesh.all_gather(x.contiguous(), AXIS,
                                               what=what), dim=-1)
        else:
            src = x
        pos = move.positions(tp.index, x.device)
        ctx.src_width = src.shape[-1]
        src = torch.cat([src, src.new_zeros(src.shape[:-1] + (1,))], -1)
        return src.index_select(-1, pos)

    @staticmethod
    def backward(ctx, g):
        move, tp = ctx.move, ctx.tp
        pos = move.positions(tp.index, g.device)
        full = g.new_zeros(g.shape[:-1] + (ctx.src_width + 1,))
        full.index_add_(-1, pos, g.contiguous())
        full = full[..., :ctx.src_width]
        if move.kind == "gather":
            full = _all_reduce(full, tp, ctx.what)
            w = move.width
            full = full[..., tp.index * w:(tp.index + 1) * w]
        return full.contiguous(), None, None, None


def reshard(x: torch.Tensor, tp: TP, move: Move, what: str) -> torch.Tensor:
    """`x` (..., width), this rank's features in ``move.have`` -> (...,
    len(move.want[rank])), contiguous; `x` itself where the layouts
    agree."""
    if move.kind == "same":
        return x
    return _Reshard.apply(x, tp, move, what)


# ---------------------------------------------------------------------------
# Head layouts of attention
# ---------------------------------------------------------------------------

class HeadLayout:
    """How a rank of a "model" axis of `tp` computes one attention call.

    ``q_move``: the projection's column blocks (H * hd / tp a rank) to the
    columns of the (padded) heads the rank attends, H_eff / tp of them,
    each a real head's hd columns or zeros; ``out_move`` back. ``kv_move``
    moves the kv projection's column blocks (every column on every rank
    where the rules replicate them: ``kv_split`` False) to the kv heads
    the rank's q heads read: its groups' heads when the groups fall on
    whole heads, else one kv head per q head. ``n_q`` and ``n_kv`` are the
    local head counts of the core."""

    def __init__(self, H: int, K: int, hd: int, tp_size: int,
                 pad_rep: Optional[Tuple[int, int, int]], kv_split: bool):
        if pad_rep is None:
            q_real = np.arange(H)
            kv_of = q_real // (H // K)
        else:
            g, rep, rep_pad = pad_rep
            p = np.arange(g * rep_pad)
            grp, j = p // rep_pad, p % rep_pad
            q_real = np.where(j < rep, grp * rep + j, -1)
            # MHA pads k, v with q (one kv head per head): a padded head's
            # k, v are zeros; GQA's padded heads read their group's
            kv_of = q_real if K == H else grp
        H_eff = len(q_real)
        if H_eff % tp_size:
            raise ValueError(
                f"{H_eff} attention heads do not split over a 'model' axis "
                f"of {tp_size}")
        if (H * hd) % tp_size:
            raise ValueError(f"the q projection's {H * hd} columns do not "
                             f"split over a 'model' axis of {tp_size}")
        n = H_eff // tp_size

        def cols(heads, width=hd):
            heads = np.asarray(heads)
            c = heads[:, None] * width + np.arange(width)
            return np.where(heads[:, None] >= 0, c, -1).reshape(-1)

        c = H * hd // tp_size
        q_blocks = [np.arange(r * c, (r + 1) * c) for r in range(tp_size)]
        attended = [q_real[r * n:(r + 1) * n] for r in range(tp_size)]
        self.q_move = Move(q_blocks, [cols(a) for a in attended])
        self.out_move = Move([cols(a) for a in attended], q_blocks)
        self.n_q = n
        kv_need, n_kv = [], set()
        for r in range(tp_size):
            heads = kv_of[r * n:(r + 1) * n]
            uniq = list(dict.fromkeys(heads.tolist()))
            per = n // len(uniq)
            if n % len(uniq) == 0 and (np.repeat(uniq, per) == heads).all():
                kv_need.append(np.asarray(uniq))
            else:
                kv_need.append(heads)
            n_kv.add(len(kv_need[-1]))
        if len(n_kv) != 1:
            # every rank's core must see one shape of kv heads
            kv_need = [kv_of[r * n:(r + 1) * n] for r in range(tp_size)]
            n_kv = {n}
        self.n_kv = n_kv.pop()
        kc = K * hd
        have = ([np.arange(r * kc // tp_size, (r + 1) * kc // tp_size)
                 for r in range(tp_size)] if kv_split
                else [np.arange(kc)] * tp_size)
        self.kv_move = Move(have, [cols(h) for h in kv_need])
        self.kv_split = kv_split


class KvSpLayout:
    """kv-SP's layout of one attention call under a "model" axis of
    `tp_size`: ``q_move`` all-gathers the projection's column blocks to
    every head on every rank, ``out_move`` keeps the rank's own columns
    of the (whole, merged) output for its ``wo`` rows, and ``kv_move``
    all-gathers the kv projection's column blocks to every kv head (the
    identity where the rules replicate the kv columns: ``kv_split``
    False); each rank then attends its block of the sequence's keys
    (``TP.seq_block``)."""

    def __init__(self, H: int, K: int, hd: int, tp_size: int,
                 kv_split: bool):
        if (H * hd) % tp_size:
            raise ValueError(f"kv-SP: the q projection's {H * hd} columns "
                             f"do not split over a 'model' axis of "
                             f"{tp_size}")
        c, kc = H * hd // tp_size, K * hd
        q_blocks = [np.arange(r * c, (r + 1) * c) for r in range(tp_size)]
        every = [np.arange(H * hd)] * tp_size
        self.q_move = Move(q_blocks, every)
        self.out_move = Move(every, q_blocks)
        have = ([np.arange(r * kc // tp_size, (r + 1) * kc // tp_size)
                 for r in range(tp_size)] if kv_split
                else [np.arange(kc)] * tp_size)
        self.kv_move = Move(have, [np.arange(kc)] * tp_size)
        self.kv_split = kv_split
        self.n_q, self.n_kv = H, K


_LAYOUTS: Dict[tuple, object] = {}


def head_layout(H: int, K: int, hd: int, tp: TP,
                pad_rep: Optional[Tuple[int, int, int]]) -> HeadLayout:
    """The (cached) HeadLayout of one attention call under `tp`."""
    key = (H, K, hd, tp.size, pad_rep, tp.splits(K * hd))
    if key not in _LAYOUTS:
        _LAYOUTS[key] = HeadLayout(H, K, hd, tp.size, pad_rep,
                                   tp.splits(K * hd))
    return _LAYOUTS[key]


def kv_sp_layout(H: int, K: int, hd: int, tp: TP) -> KvSpLayout:
    """The (cached) KvSpLayout of one attention call under `tp`."""
    key = ("kv-SP", H, K, hd, tp.size, tp.splits(K * hd))
    if key not in _LAYOUTS:
        _LAYOUTS[key] = KvSpLayout(H, K, hd, tp.size, tp.splits(K * hd))
    return _LAYOUTS[key]


# ---------------------------------------------------------------------------
# kv-SP's attention core
# ---------------------------------------------------------------------------

def merge_blocks(o: torch.Tensor, lse: torch.Tensor, tp: TP, what: str
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """kv-SP's merge of the ranks' attention over their blocks of the keys:
    `o` (B, Sq, H, hd) and `lse` (B, H, Sq) fp32 this rank's; returns the
    whole attention's (out in fp32, its log-sum-exp): L = max_r lse_r +
    log sum_r exp(lse_r - max_r lse_r), out = sum_r exp(lse_r - L) o_r.
    One all-reduce of the max (``what.max``) and one of the weighted
    outputs packed with their weights (``what.sum``). A rank whose row saw
    no key (lse -1e30) adds it a weight of exactly 0."""
    hd = o.shape[-1]
    m = _all_reduce(lse, tp, f"{what}.max", op=dist.ReduceOp.MAX)
    w = torch.exp(lse - m).transpose(1, 2)[..., None]       # (B, Sq, H, 1)
    packed = _all_reduce(torch.cat([o.float() * w, w], dim=-1), tp,
                         f"{what}.sum")
    num, den = packed[..., :hd], packed[..., hd:]
    return num / den, m + torch.log(den[..., 0]).transpose(1, 2)


class _KvSpCore(torch.autograd.Function):
    """Attention of every head's queries over the rank's block of the keys,
    merged over "model" (see ``kv_sp_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, tp, causal, window, k_offset, what):
        from repro_torch.kernels import flash_attention as kf

        B, Sq, H, hd = q.shape
        if k.shape[1]:
            o, lse = kf.flash_attention_lse(q, k, v, causal=causal,
                                            window=window, k_offset=k_offset)
        else:                         # an empty block: no key, weight 0
            o = q.new_zeros(q.shape)
            lse = q.new_full((B, H, Sq), NEG_INF, dtype=torch.float32)
        out, lse = merge_blocks(o, lse, tp, what)
        out = out.to(q.dtype)
        lse = lse.contiguous()
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tp, ctx.what = tp, what
        ctx.causal, ctx.window, ctx.k_offset = causal, window, k_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels import flash_attention as kf

        q, k, v, out, lse = ctx.saved_tensors
        # each rank's `out` fed only its own columns to its wo rows: the
        # whole dO is the sum of the ranks' (the transpose of the
        # forward's selection)
        dout = _all_reduce(dout, ctx.tp, f"{ctx.what}.dout")
        if not k.shape[1]:
            return (torch.zeros_like(q), torch.zeros_like(k),
                    torch.zeros_like(v)) + (None,) * 5
        dq, dk, dv = kf.flash_attention_bwd(
            q, k, v, out, dout, lse, causal=ctx.causal, window=ctx.window,
            k_offset=ctx.k_offset)
        return dq, dk, dv, None, None, None, None, None


def kv_sp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    tp: TP, *, causal: bool, window: int = 0,
                    k_offset: int = 0, what: str = "attn.merge"
                    ) -> torch.Tensor:
    """kv-SP's core: `q` (B, Sq, H, hd), every head's queries, the same on
    every rank; `k`, `v` (B, Sk_r, K, hd) the rank's block of the keys,
    key 0 at position `k_offset`. K7 with its log-sum-exp on the block,
    then the merge over "model": L = logsumexp_r lse_r, out = sum_r
    exp(lse_r - L) out_r in fp32 (one all-reduce of the max, one of the
    weighted outputs and weights), rounded once to q's dtype; the same
    (B, Sq, H, hd) on every rank. A row or a block that sees no key has
    lse -1e30 and a weight of exactly 0. Backward (``_KvSpCore``): dO
    summed over "model", then K7b on the merged output and log-sum-exp:
    dq is the rank's part (the q move's backward sums it), dk and dv are
    whole for the rank's keys."""
    return _KvSpCore.apply(q, k, v, tp, causal, window, k_offset, what)


# ---------------------------------------------------------------------------
# The vocabulary over "model"
# ---------------------------------------------------------------------------

def vocab_embed(tokens: torch.Tensor, emb: torch.Tensor, tp: TP
                ) -> torch.Tensor:
    """The rows of `tokens` from the rank's block of the embedding (its
    vocabulary rows; zeros for the others), summed over "model"."""
    n = emb.shape[0]
    start = tp.index * n
    local = tokens.long() - start
    inside = (local >= 0) & (local < n)
    rows = F.embedding(local.clamp(0, n - 1), emb)
    rows = rows * inside[..., None].to(rows.dtype)
    return leave(rows, tp, "embed")


def vocab_logits(x: torch.Tensor, table: torch.Tensor, tp: TP, *,
                 softcap: float, vocab_size: int) -> torch.Tensor:
    """fp32 logits (..., the rank's vocabulary rows) of the replicated,
    normed `x` against the rank's block of the head's table: soft-capped,
    then the padded rows (ids at or past `vocab_size`) masked to -1e30."""
    x = enter(x, tp, "head")
    logits = (x @ table.t()).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    n = table.shape[0]
    start = tp.index * n
    if start + n > vocab_size:
        ids = torch.arange(start, start + n, device=logits.device)
        logits = torch.where(ids >= vocab_size, NEG_INF, logits)
    return logits


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, tp: TP
              ) -> torch.Tensor:
    """Per-token -log softmax(logits)[label] over the whole vocabulary,
    from each rank's (..., V / tp) fp32 logits: the max, the sum of
    exponentials and the label's logit over "model"."""
    n = logits.shape[-1]
    m = _all_reduce(logits.detach().amax(dim=-1), tp, "head.max",
                    op=dist.ReduceOp.MAX)
    s = leave(torch.exp(logits - m[..., None]).sum(dim=-1), tp, "head.sum")
    local = labels.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    picked = leave(torch.where(inside, picked, 0.0), tp, "head.label")
    return m + torch.log(s) - picked


def gather_vocab(logits: torch.Tensor, tp: TP) -> torch.Tensor:
    """Every rank's vocabulary block of `logits`, concatenated (a forward
    that returns the full logits; no gradient flows back)."""
    return torch.cat(tp.mesh.all_gather(logits.detach().contiguous(), AXIS,
                                        what="head.logits"), dim=-1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, full: int, tp: TP,
             what: str, eps: float = 1e-6) -> torch.Tensor:
    """``layers.rms_norm`` over a last dim of `full` features split over
    "model": `x` and `scale` are the rank's blocks; the sum of squares is
    summed over "model"."""
    xf = x.float()
    ss = psum((xf * xf).sum(dim=-1, keepdim=True), tp, what)
    out = xf * torch.rsqrt(ss / full + eps) * (1.0 + scale.float())
    return out.to(x.dtype)
