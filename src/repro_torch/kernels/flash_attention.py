"""Flash attention: the forward pass (kernel K7) and its backward (K7b).

    flash_attention      q (B, Sq, H, d), k/v (B, Sk, K, d), H % K == 0
                         -> (B, Sq, H, d) in q's dtype; differentiable
    flash_attention_lse  the same and each row's fp32 log-sum-exp of its
                         scaled scores, (B, H, Sq)
    flash_attention_bwd  (q, k, v, out, dout, lse) -> (dq, dk, dv)

The attention core of the dense LM where it attends a whole in-context
sequence: ``LanguageModel.forward`` and the prefill into a fresh cache.
Query positions count from 0 and key j sits at position j + ``k_offset``
(0 but for kv-SP, where a rank holds one block of the sequence's keys);
with rel = i - (j + k_offset) the mask keeps key j for query i when j <
Sk, rel >= 0 if ``causal`` and rel < ``window`` if ``window > 0``;
masked scores are the finite -1e30 and the softmax runs in fp32; the
scale is 1/sqrt(d); query head h reads kv head h // (H / K). A row that
sees no key gets out 0, log-sum-exp -1e30 (``NEG_INF``) and dq 0, in the
kernels and their twins alike.

``flash_attention`` launches a hand-written CUDA kernel (``csrc/flash.cu``)
on CUDA tensors and the plain PyTorch twin ``flash_attention_ref`` on CPU
tensors. The kernel's design is chosen by dtype and head size alone
(``uses_wgmma``): bf16 at d = 64 or 128 runs the Hopper design (TMA,
mbarriers, wgmma), every other case the sm_80-unit kernels. Every kernel
launch adds one to ``LAUNCHES["flash_attention"]``, and a launch of the
Hopper design one more to ``LAUNCHES["flash_attention_wgmma"]``, so a run
shows which design served it; a launch with a nonzero ``k_offset`` adds
one to ``LAUNCHES["flash_attention_offset"]`` as well (K7b likewise, under
``flash_attention_bwd_offset``).

Gradients: where q, k or v requires one on the card, ``flash_attention``
runs ``_FlashFn``, whose forward is K7 writing the log-sum-exp as well and
whose backward is K7b (``csrc/flash_bwd.cu``: D = rowsum(dO * O), then dK
and dV per key tile and dQ per query tile, recomputing P from q, k and the
log-sum-exp; no float atomics, so repeat launches are bit-identical),
chosen as K7's design is: bf16 at d = 64 or 128 runs K7b's Hopper design
(TMA rings, wgmma), every other case the sm_80-unit kernels. Each K7b call
(three kernels in order) adds one to ``LAUNCHES["flash_attention_bwd"]``,
and one through the Hopper design one more to
``LAUNCHES["flash_attention_bwd_wgmma"]``. On the CPU ``_FlashFn``'s
backward is ``flash_attention_bwd_ref``, the gradient of the twin by
autograd: K7b's plain twin. Given a log-sum-exp (kv-SP's merged one),
``flash_attention_bwd`` on the CPU computes K7b's own formula from the
given out and lse instead (``flash_attention_bwd_ref(..., lse=)``).
The reference trains through its jnp core (``repro.models.attention.
blockwise_attention``) and differentiates it with ``jax.grad``: K7b is
the port's counterpart of that gradient, not of a Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.device import (DTYPES, launch, on_cuda, opaque,
                                        stream)

NEG_INF = -1e30
HEAD_DIMS = tuple(range(16, 129, 16))    # the head sizes the kernel takes
WGMMA_HEAD_DIMS = (64, 128)              # bf16 head sizes of the Hopper design

# the per-row LSE / D scratch of K7b's Hopper design: rows padded to this
PAD_ROWS = 128

# kernel launches since the counter was last set to 0: every K7 launch, the
# subset that ran the Hopper (wgmma) design, the subset with a nonzero key
# offset (kv-SP's), and the same three of K7b's calls
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_offset": 0, "flash_attention_bwd": 0,
            "flash_attention_bwd_wgmma": 0, "flash_attention_bwd_offset": 0}


def uses_wgmma(dtype: torch.dtype, d: int) -> bool:
    """True when a CUDA call of this dtype and head size runs the Hopper
    designs (K7's ``flash_wgmma``, K7b's ``bwd_dkdv_wgmma`` and
    ``bwd_dq_wgmma``), False when it runs the sm_80-unit kernels
    (``flash_bf16`` or ``flash_f32``; ``bwd_*_bf16`` or ``bwd_*_f32``)."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS


def _mask(sq: int, sk: int, causal: bool, window: int, device,
          k_offset: int = 0) -> torch.Tensor:
    """(Sq, Sk) visibility: True where query i may attend key j (at
    position j + k_offset)."""
    rel = (torch.arange(sq, device=device)[:, None]
           - torch.arange(sk, device=device)[None, :] - k_offset)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    return mask


def _scores_ref(q, k, causal, window, k_offset=0):
    """(B, H, Sq, Sk) fp32 scaled scores, masked to NEG_INF, the kv heads'
    repeat count H / K, and the (Sq, Sk) mask."""
    B, Sq, H, d = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    mask = _mask(Sq, k.shape[1], causal, window, q.device, k_offset)
    return s.masked_fill(~mask, NEG_INF), rep, mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        k_offset: int = 0) -> torch.Tensor:
    """The plain twin: fp32 scores and softmax over all Sk keys at once,
    GQA by repeating each kv head H / K times; a row that sees no key is
    0. Differentiable."""
    s, rep, mask = _scores_ref(q, k, causal, window, k_offset)
    vf = v.float().repeat_interleave(rep, dim=2)
    p = torch.softmax(s, dim=-1) * mask.any(dim=1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: int = 0, k_offset: int = 0) -> torch.Tensor:
    """Each row's fp32 log-sum-exp of its masked scaled scores, (B, H,
    Sq), NEG_INF for a row that sees no key: the twin of K7's second
    output."""
    s, _, mask = _scores_ref(q, k, causal, window, k_offset)
    return torch.where(mask.any(dim=1), torch.logsumexp(s, dim=-1), NEG_INF)


def _bwd_given(q, k, v, out, dout, lse, causal, window, k_offset):
    """(dq, dk, dv) in fp32 by K7b's formula from the given `out` and
    `lse`: P = exp(s - lse) where seen (else 0), D = rowsum(dout * out),
    dS = P (dP - D)."""
    B, Sq, H, d = q.shape
    K = k.shape[2]
    s, rep, mask = _scores_ref(q, k, causal, window, k_offset)
    p = torch.where(mask, torch.exp(s - lse.float()[..., None]), 0.0)
    g = dout.float()
    delta = (g * out.float()).sum(-1).transpose(1, 2)          # (B, H, Sq)
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", g, vf) - delta[..., None])
    scale = 1.0 / d ** 0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    Sk = k.shape[1]
    return (dq, dk.reshape(B, Sk, K, rep, d).sum(3),
            dv.reshape(B, Sk, K, rep, d).sum(3))


def flash_attention_bwd_ref(q, k, v, dout, *, causal: bool = True,
                            window: int = 0, k_offset: int = 0, out=None,
                            lse=None):
    """K7b's plain twin: (dq, dk, dv) of <dout, attention(q, k, v)> by
    autograd through ``flash_attention_ref``, in the inputs' dtypes.

    With `out`, the forward's output as the backward is given it (rounded
    to the inputs' dtype), dq is the gradient given that output: each
    row's D = <dout_i, o_i> enters every dS_ij = P_ij (dP_ij - D_i), so
    dq_i moves by -(D_i(out) - D_i(exact)) sum_j P_ij k_j / sqrt(d), a
    shift of the whole row that the rounding of `out` causes, not the
    backward. dk and dv sum it over many queries and are left as they
    are.

    With `lse` as well (and `out`), K7b's formula runs on them as given
    (``_bwd_given``): kv-SP's merged output and log-sum-exp over every
    rank's keys make P the global softmax on this rank's keys, dk and dv
    whole for them and dq this rank's part of the sum."""
    if lse is not None:
        if out is None:
            raise ValueError("the backward given an lse needs its out too")
        grads = _bwd_given(q, k, v, out, dout, lse, causal, window,
                           k_offset)
        return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    with torch.enable_grad():
        exact = flash_attention_ref(*leaves, causal=causal, window=window,
                                    k_offset=k_offset)
        dq, dk, dv = torch.autograd.grad(exact, leaves, dout.float())
    if out is not None:
        shift = (dout.float() * (out.float() - exact.detach())).sum(
            -1, keepdim=True)
        pk = flash_attention_ref(leaves[0].detach(), leaves[1].detach(),
                                 leaves[1].detach(), causal=causal,
                                 window=window, k_offset=k_offset)
        dq = dq - shift * pk / q.shape[-1] ** 0.5
    return tuple(g.to(t.dtype) for g, t in zip((dq, dk, dv), (q, k, v)))


def _check(q, k, v, window, k_offset=0):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be (B, S, heads, d)")
    B, Sq, H, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be (B={B}, Sk, K, d={d})")
    K = k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv "
                         "heads")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a float32/bfloat16 dtype, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head size {d} is not one of {HEAD_DIMS}")
    if min(Sq, k.shape[1], B) < 1 or window < 0 or k_offset < 0:
        raise ValueError(f"empty input or negative window or key offset: "
                         f"q {tuple(q.shape)}, k {tuple(k.shape)}, window "
                         f"{window}, k_offset {k_offset}")


def _check_layout(*ts):
    """The kernels read d with unit stride and stage rows in 16-byte copies
    (cp.async or TMA): the other strides multiples of 8 elements, pointers
    16-byte aligned; grid extents H and B at most 65535."""
    for t in ts:
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"flash_attention needs a unit d stride, "
                             f"strides that are multiples of 8 and 16-byte "
                             f"alignment, got strides {t.stride()}")
    if ts[0].shape[2] > 65535 or ts[0].shape[0] > 65535:
        raise ValueError(f"q {tuple(ts[0].shape)}: B and H must be <= 65535")


def _launch_forward(q, k, v, causal: bool, window: int, with_lse: bool,
                    k_offset: int = 0):
    """One K7 launch: the output and, with `with_lse`, the (B, H, Sq) fp32
    log-sum-exp (else None, and the kernel writes none). A nonzero
    `k_offset` always writes it (the Hopper design's offset problem
    carries it)."""
    _check_layout(q, k, v)
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse or k_offset else None)
    wgmma = uses_wgmma(q.dtype, d)
    launch("flash_attention_wgmma" if wgmma else "flash_attention",
           DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), B, Sq, Sk, H, K, d, *q.stride()[:3],
           *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], int(causal),
           int(window), int(k_offset),
           None if lse is None else lse.data_ptr(), stream())
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_wgmma"] += wgmma
    LAUNCHES["flash_attention_offset"] += k_offset > 0
    return out, lse


class _FlashFn(torch.autograd.Function):
    """Attention with a gradient. On the card: K7 forward (writing the
    log-sum-exp too), K7b backward. On the CPU: the twin forward and its
    gradient ``flash_attention_bwd_ref`` (autograd through the twin, the
    same bits as differentiating the forward's graph), so that on either
    device the backward is one ``flash_attention_bwd`` call."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, k_offset):
        if on_cuda(q, k, v):
            out, lse = _launch_forward(q, k, v, causal, window, True,
                                       k_offset)
        else:
            out = flash_attention_ref(q, k, v, causal=causal, window=window,
                                      k_offset=k_offset)
            lse = None
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window, ctx.k_offset = causal, window, k_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal,
                                         window=ctx.window,
                                         k_offset=ctx.k_offset)
        return dq, dk, dv, None, None, None


@opaque("flash_attention")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    k_offset: int = 0) -> torch.Tensor:
    """Attention of the Sq queries over the Sk keys (key j at position j +
    `k_offset`), one launch. Where q, k or v requires a gradient (and grad
    mode is on), the backward is K7b on the card and the twin's gradient
    on the CPU (``_FlashFn``)."""
    _check(q, k, v, window, k_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashFn.apply(q, k, v, causal, window, k_offset)
    if not on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   k_offset=k_offset)
    return _launch_forward(q, k, v, causal, window, False, k_offset)[0]


@opaque("flash_attention")
def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        k_offset: int = 0):
    """(out, lse): K7 with its log-sum-exp output on the card, the twins on
    the CPU. Not differentiable."""
    _check(q, k, v, window, k_offset)
    if not on_cuda(q, k, v):
        return (flash_attention_ref(q, k, v, causal=causal, window=window,
                                    k_offset=k_offset),
                lse_ref(q, k, causal=causal, window=window,
                        k_offset=k_offset))
    with torch.no_grad():
        return _launch_forward(q, k, v, causal, window, True, k_offset)


def _bwd_rows_shape(B: int, H: int, Sq: int, wgmma: bool) -> tuple:
    """K7b's fp32 per-row scratch: D of every row, (B, H, Sq); the Hopper
    design's holds each row's LSE in log2 units, then D, (B, H, 2, Sq
    padded to PAD_ROWS), zero past Sq, so that its ring copies whole
    16-byte-aligned slices."""
    if wgmma:
        return (B, H, 2, -(-Sq // PAD_ROWS) * PAD_ROWS)
    return (B, H, Sq)


@opaque("flash_attention_bwd")
def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: int = 0, k_offset: int = 0):
    """(dq, dk, dv) of <dout, flash_attention(q, k, v)> given the forward's
    `out` and `lse` (or kv-SP's merged ones): one K7b call on the card
    (``dout`` copied to a contiguous tensor where the kernel cannot read
    its layout), through the Hopper design where ``uses_wgmma`` says so.
    On the CPU the twin: with `lse` None its autograd (which recomputes the
    forward and ignores `out`), else K7b's formula on the given `out` and
    `lse`."""
    _check(q, k, v, window, k_offset)
    B, Sq, H, d = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if tuple(t.shape) != tuple(q.shape) or t.dtype != q.dtype:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} must match "
                             f"q {tuple(q.shape)} {q.dtype}")
    if not on_cuda(q, k, v, out, dout):
        return flash_attention_bwd_ref(
            q, k, v, dout, causal=causal, window=window, k_offset=k_offset,
            out=None if lse is None else out, lse=lse)
    if lse is None or tuple(lse.shape) != (B, H, Sq) or \
            lse.dtype != torch.float32 or not lse.is_contiguous() or \
            lse.device != q.device:
        raise ValueError(f"lse must be the forward's contiguous fp32 "
                         f"(B, H, Sq) = {(B, H, Sq)} on {q.device}")
    if dout.stride(3) != 1 or any(s % 8 for s in dout.stride()[:3]) \
            or dout.data_ptr() % 16:
        dout = dout.contiguous()
    _check_layout(q, k, v, out, dout)
    Sk, K = k.shape[1], k.shape[2]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    wgmma = uses_wgmma(q.dtype, d)
    delta = torch.empty(_bwd_rows_shape(B, H, Sq, wgmma),
                        dtype=torch.float32, device=q.device)
    launch("flash_attention_bwd_wgmma" if wgmma else "flash_attention_bwd",
           DTYPES[q.dtype], q.data_ptr(),
           k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
           dv.data_ptr(), B, Sq, Sk, H, K, d,
           *(s for t in (q, k, v, out, dout, dq, dk, dv)
             for s in t.stride()[:3]),
           int(causal), int(window), int(k_offset), stream())
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES["flash_attention_bwd_wgmma"] += wgmma
    LAUNCHES["flash_attention_bwd_offset"] += k_offset > 0
    return dq, dk, dv
