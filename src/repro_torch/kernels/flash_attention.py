"""Flash-attention forward pass (kernel K7).

    flash_attention  q (B, Sq, H, d), k/v (B, Sk, K, d), H % K == 0
                     -> (B, Sq, H, d) in q's dtype

The attention core of the dense LM where it attends a whole in-context
sequence: ``LanguageModel.forward`` and the prefill into a fresh cache.
Query and key positions both count from 0; the mask keeps key j for query
i when j < Sk, i - j >= 0 if ``causal`` and i - j < ``window`` if
``window > 0``; masked scores are the finite -1e30 and the softmax runs in
fp32; the scale is 1/sqrt(d); query head h reads kv head h // (H / K).

``flash_attention`` launches a hand-written CUDA kernel (``csrc/flash.cu``)
on CUDA tensors and the plain PyTorch twin ``flash_attention_ref`` on CPU
tensors. The kernel's design is chosen by dtype and head size alone
(``uses_wgmma``): bf16 at d = 64 or 128 runs the Hopper design (TMA,
mbarriers, wgmma), every other case the sm_80-unit kernels. Every kernel
launch adds one to ``LAUNCHES["flash_attention"]``, and a launch of the
Hopper design one more to ``LAUNCHES["flash_attention_wgmma"]``, so a run
shows which design served it. There is no backward pass yet, so an input
that requires a gradient raises instead of losing it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.device import DTYPES, launch, on_cuda, stream

NEG_INF = -1e30
HEAD_DIMS = tuple(range(16, 129, 16))    # the head sizes the kernel takes
WGMMA_HEAD_DIMS = (64, 128)              # bf16 head sizes of the Hopper design

# kernel launches since the counter was last set to 0: every K7 launch, and
# the subset that ran the Hopper (wgmma) design
LAUNCHES = {"flash_attention": 0, "flash_attention_wgmma": 0}


def uses_wgmma(dtype: torch.dtype, d: int) -> bool:
    """True when a CUDA call of this dtype and head size runs the Hopper
    design (``flash_wgmma``), False when it runs ``flash_bf16`` or
    ``flash_f32``."""
    return dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS


def _mask(sq: int, sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    """(Sq, Sk) visibility: True where query i may attend key j."""
    rel = (torch.arange(sq, device=device)[:, None]
           - torch.arange(sk, device=device)[None, :])
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= rel >= 0
    if window > 0:
        mask &= rel < window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """The plain twin: fp32 scores and softmax over all Sk keys at once,
    GQA by repeating each kv head H / K times."""
    B, Sq, H, d = q.shape
    rep = H // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    s = s.masked_fill(~_mask(Sq, k.shape[1], causal, window, q.device),
                      NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def _check(q, k, v, window):
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
    if min(Sq, k.shape[1], B) < 1 or window < 0:
        raise ValueError(f"empty input or negative window: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, window {window}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attention has no backward pass yet: inputs "
                         "must not require a gradient")


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Attention of the Sq queries over the Sk keys, one launch."""
    _check(q, k, v, window)
    if not on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_layout(q, k, v)
    B, Sq, H, d = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, d), dtype=q.dtype, device=q.device)
    wgmma = uses_wgmma(q.dtype, d)
    launch("flash_attention_wgmma" if wgmma else "flash_attention",
           DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), B, Sq, Sk, H, K, d, *q.stride()[:3],
           *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], int(causal),
           int(window), stream())
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_wgmma"] += wgmma
    return out
