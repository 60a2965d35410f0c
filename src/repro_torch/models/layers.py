"""Layer primitives of the LMs: init, the norms (RMS; LayerNorm for the
enc-dec family), rotary embeddings (RoPE; Qwen2-VL's M-RoPE), the MLPs
(SwiGLU, GeGLU and the plain GELU MLP) and logit soft-capping.

Plain functions over explicit param dicts, computing what the reference's
``repro.models.layers`` computes (not Hugging Face's Llama): the RMS norm
scales by ``1 + scale`` in fp32, LayerNorm by ``scale`` and adds ``b`` in
fp32, rotary embeddings rotate split halves at fp32 angles.
Initialisers draw from a ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tpm


# the most fp32 elements ``dense_init`` draws at once (1 GiB): a larger
# leaf is drawn in slices of whole rows, so that its fp32 temporary stays
# this size (Qwen3-30B-A3B's stacked experts are 9.7e9 elements)
DRAW_ELEMS = 1 << 28


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype,
               device, scale: float = 1.0) -> torch.Tensor:
    """Normal * scale / sqrt(fan_in) (the reference's std), drawn in fp32
    and then cast; scale 0 gives zeros and draws nothing. fan_in is the
    second-to-last axis, so a stacked (layers, d_in, d_out) leaf is drawn
    as its layers would be. The leaf is drawn in consecutive slices of at
    most ``DRAW_ELEMS`` elements, whole rows each (one slice, the whole
    leaf, up to that size)."""
    if scale == 0.0:
        return torch.zeros(shape, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if out.is_meta:
        return out
    div = math.sqrt(shape[-2]) / scale
    rows = out.view(-1, shape[-1])
    step = max(1, DRAW_ELEMS // shape[-1])
    for i in range(0, rows.shape[0], step):
        n = min(step, rows.shape[0] - i)
        w = torch.randn((n, shape[-1]), generator=gen, dtype=torch.float32,
                        device=device)
        rows[i:i + n] = (w / div).to(dtype)
    return out


NORMS = ("rms", "ln")


def norm_init(cfg, device, stack: Tuple[int, ...] = ()) -> dict:
    """RMS: ``scale`` zeros (the norm scales by 1 + scale); LayerNorm:
    ``scale`` ones and ``b`` zeros. All fp32."""
    if cfg.norm not in NORMS:
        raise NotImplementedError(f"norm {cfg.norm!r}: the port builds the "
                                  f"norms {NORMS}")
    shape = stack + (cfg.d_model,)
    if cfg.norm == "rms":
        return {"scale": torch.zeros(shape, dtype=torch.float32,
                                     device=device)}
    return {"scale": torch.ones(shape, dtype=torch.float32, device=device),
            "b": torch.zeros(shape, dtype=torch.float32, device=device)}


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, cfg) -> torch.Tensor:
    if cfg.norm == "rms":
        return rms_norm(x, p["scale"])
    if cfg.norm == "ln":
        return layer_norm(x, p["scale"], p["b"])
    raise NotImplementedError(f"norm {cfg.norm!r}: the port builds the "
                              f"norms {NORMS}")


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """x (B, S, H, hd), positions (B, S), or (B, 3, S) streams: rotate the
    two halves of each head by fp32 angles position * freq.

    M-RoPE (Qwen2-VL, ``mrope_sections``): the hd/2 frequency slots are
    split into (t, h, w) sections, each rotated by its own position
    stream; where the three streams are equal it is RoPE. Without
    sections a (B, 3, S) input rotates by stream 0."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if mrope_sections:
        if positions.dim() != 3 or positions.shape[1] != 3:
            raise ValueError(f"M-RoPE needs (B, 3, S) positions, got "
                             f"{tuple(positions.shape)}")
        if sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE sections {mrope_sections} must cover "
                             f"hd/2 = {hd // 2}")
        stream = torch.cat([torch.full((n,), i, dtype=torch.long,
                                       device=x.device)
                            for i, n in enumerate(mrope_sections)])
        pos = positions.float()[:, stream, :]            # (B, hd/2, S)
        angles = (pos.transpose(1, 2) * freqs)[:, :, None, :]
    else:
        if positions.dim() == 3:
            positions = positions[:, 0]
        angles = (positions.float()[..., None] * freqs)[:, :, None, :]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# the MLPs the port builds: SwiGLU ("silu") and GeGLU ("gelu") gated,
# GPT-BigCode's plain GELU MLP ("gelu_mlp") without a gate
GATED_ACTS = ("silu", "gelu")
ACTS = GATED_ACTS + ("gelu_mlp",)


def _check_act(cfg) -> None:
    if cfg.act not in ACTS:
        raise NotImplementedError(f"activation {cfg.act!r}: the port builds "
                                  f"the MLPs {ACTS}")


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU's tanh approximation, what ``jax.nn.gelu`` computes by default
    (the exact erf form differs from it by up to ~1e-3)."""
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, cfg, device,
             stack: Tuple[int, ...] = (), d_ff: int = 0) -> dict:
    """The MLP's weights at width ``d_ff`` (default: the config's d_ff):
    ``w_in`` and ``w_out``, and ``w_gate`` for the gated activations."""
    _check_act(cfg)
    dtype = getattr(torch, cfg.dtype)
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": dense_init(gen, stack + (d, f), dtype, device),
         "w_out": dense_init(gen, stack + (f, d), dtype, device)}
    if cfg.act in GATED_ACTS:
        p["w_gate"] = dense_init(gen, stack + (d, f), dtype, device)
    return p


def apply_mlp(x: torch.Tensor, p: dict, cfg, tp=None,
              d_ff: int = 0) -> torch.Tensor:
    """Gated: (act(x W_gate) * x W_in) W_out, act silu or gelu; plain:
    gelu(x W_in) W_out. Under `tp` (a mesh's "model" axis, where it
    splits the hidden width `d_ff`, default the config's) column-parallel
    in ``w_in`` / ``w_gate`` and row-parallel in ``w_out``: the rank's
    hidden columns, then one all-reduce of the partial outputs (the
    reference's ``layers.py:144-146``)."""
    _check_act(cfg)
    if tp is not None and tp.check_local(p["w_out"], d_ff or cfg.d_ff, -2,
                                         "w_out"):
        return tpm.leave(apply_mlp(tpm.enter(x, tp, "mlp"), p, cfg), tp,
                         "mlp.w_out")
    h = x @ p["w_in"]
    if "w_gate" in p:
        g = x @ p["w_gate"]
        h = (F.silu(g) if cfg.act == "silu" else gelu(g)) * h
    else:
        h = gelu(h)
    return h @ p["w_out"]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap
