"""Mamba-2 blocks (SSD, state-space duality: arXiv:2405.21060), the
reference's ``repro.models.ssm``.

``ssd_chunked`` computes what the reference's single ``lax.scan`` over
chunks of Q tokens computes: the running state h (B, H, P, N) carried in
fp32 from chunk to chunk, and the decay-masked (Q, Q) scores of one chunk
at a time (never of the whole sequence). The reference's products are
plain tensor products, and so are these (``torch.matmul``; the reference
computes them outside any Pallas kernel): the scores C B^T per group (the
reference repeats B and C over the group's heads first; the products are
the same), the intra-chunk part (scores * L) (x dt), the inter-chunk part
exp(cum) C h^T and the carried h. All of it in fp32, at IEEE precision
(``repro_torch`` turns TF32 off).

The decay mask L_ij = exp(cum_i - cum_j) is masked BEFORE the ``exp``
(-inf above the diagonal, ``_masked_scores``), where the reference masks
after it (``where(causal, exp(diff), 0)``). The values are the same; the
gradients are not. Above the diagonal diff = cum_i - cum_j with j > i is
positive (cum falls along a chunk) and grows with the chunk: past ~88 its
``exp`` overflows to inf in fp32, and the masked zero's cotangent times
that inf is NaN. At the configs' chunk of 256, with the reference's init
(A_log 0), the reference's dt and A gradients are NaN; masking first
keeps every gradient finite, and equal to the reference's at a chunk
short enough for its own to stay finite (chunking is exact;
``tests/test_torch_ssm.py`` pins the port's chunk-256 gradient to the
reference's at chunk 64).

Decode (one token, with a state) is the O(1) update h <- exp(dt A) h +
dt B x, y = C h. The state (``SSMState``: the three conv tails in the
model's dtype, h in fp32) is written in place, as the KV caches are
(``models/attention.py``): the returned state shares the caller's tensors.
Prompts must be of equal length: a padded prompt would run its pad tokens
through the recurrence (why the serving engine refuses these families).

Under a mesh whose "model" axis is larger than one (``tp``; the
reference's ``ssm.py:168-208``) the heads are split over "model": a rank
projects its columns of ``z``, ``x`` and ``dt``, convolves its channels
of ``x`` and runs the SSD on its H / tp heads with its blocks of
``A_log``, ``dt_bias`` and ``skip_d``; B and C stay replicated (each rank
reads them for its own heads, so their params' gradients are summed over
"model", as is ``norm_scale``'s, of which a rank reads its channels); the
gated RMS norm runs over the full ``d_inner``, its sum of squares summed
over "model"; ``out_proj``'s rows are followed by one all-reduce. The
decode state is not run under a mesh (serving under a mesh waits).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import tensor_parallel as tpm
from repro_torch.models import layers


def ssm_dims(cfg) -> Tuple[int, int]:
    """(d_inner, heads) of the config's SSM."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim


def ssm_init(gen: torch.Generator, cfg, device,
             stack: Tuple[int, ...] = ()) -> dict:
    """The reference's SSM params: the z/x/B/C/dt input projections and
    the x/B/C conv weights stored apart (conv scale 0.5 over fan_in =
    conv_width), the output projection, and fp32 zeros for A_log,
    dt_bias, skip_d and norm_scale."""
    s = cfg.ssm
    dtype = getattr(torch, cfg.dtype)
    d, (d_inner, n_heads) = cfg.d_model, ssm_dims(cfg)
    gn = s.n_groups * s.state_dim
    w = s.conv_width

    def dense(shape, scale=1.0):
        return layers.dense_init(gen, stack + shape, dtype, device, scale)

    def zeros(n):
        return torch.zeros(stack + (n,), dtype=torch.float32, device=device)
    return {
        "in_proj": {"z": dense((d, d_inner)), "x": dense((d, d_inner)),
                    "B": dense((d, gn)), "C": dense((d, gn)),
                    "dt": dense((d, n_heads))},
        "conv_w": {"x": dense((w, d_inner), 0.5), "B": dense((w, gn), 0.5),
                   "C": dense((w, gn), 0.5)},
        "out_proj": dense((d_inner, d)),
        "A_log": zeros(n_heads), "dt_bias": zeros(n_heads),
        "skip_d": zeros(n_heads), "norm_scale": zeros(d_inner),
    }


class SSMState(NamedTuple):
    """A layer's decode state (with leading stack axes in a cache):
    conv_x (B, W-1, d_inner), conv_B / conv_C (B, W-1, G*N) in the model's
    dtype, h (B, H, P, N) in fp32."""
    conv_x: torch.Tensor
    conv_B: torch.Tensor
    conv_C: torch.Tensor
    h: torch.Tensor


def init_ssm_state(batch: int, cfg, dtype, device,
                   stack: Tuple[int, ...] = ()) -> SSMState:
    s = cfg.ssm
    d_inner, n_heads = ssm_dims(cfg)
    gn = s.n_groups * s.state_dim
    w1 = s.conv_width - 1

    def zeros(shape, dt):
        return torch.zeros(stack + shape, dtype=dt, device=device)
    return SSMState(zeros((batch, w1, d_inner), dtype),
                    zeros((batch, w1, gn), dtype),
                    zeros((batch, w1, gn), dtype),
                    zeros((batch, n_heads, s.head_dim, s.state_dim),
                          torch.float32))


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv, u (B, S, C), w (W, C): the W taps summed in
    the reference's order, then silu. Returns (out, the last W-1 rows of
    the context: the new state)."""
    W, S = w.shape[0], u.shape[1]
    if state is not None:
        ctx = torch.cat([state.to(u.dtype), u], dim=1)
    else:
        ctx = F.pad(u, (0, 0, W - 1, 0))
    out = ctx[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + ctx[:, i:i + S] * w[i]
    return F.silu(out), ctx[:, ctx.shape[1] - (W - 1):]


def _causal(Q: int, device) -> torch.Tensor:
    return torch.ones((Q, Q), dtype=torch.bool, device=device).tril()


def _masked_scores(cum: torch.Tensor, scores: torch.Tensor, rep: int,
                   causal: torch.Tensor):
    """One chunk's decay mask L_ij = exp(cum_i - cum_j) for j <= i (0
    above the diagonal: `causal` is the (Q, Q) lower triangle) and M = L *
    (C_i . B_j): cum (B, H, Q), scores (B, G, Q, Q) -> L, M (B, H, Q, Q)."""
    Bsz, H, Q = cum.shape
    G = scores.shape[1]
    L = torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                              float("-inf")))
    M = (L.view(Bsz, G, rep, Q, Q) * scores[:, :, None]).view(Bsz, H, Q, Q)
    return L, M


class _IntraChunk(torch.autograd.Function):
    """The intra-chunk term y_i = sum_{j<=i} exp(cum_i - cum_j) (C_i.B_j)
    xdt_j of every chunk, one chunk at a time: cum (B, nc, H, Q), scores
    (B, nc, G, Q, Q), xdt (B, nc, H, Q, P) -> (B, nc, H, Q, P). The
    backward recomputes each chunk's (H, Q, Q) mask and scores from cum
    and scores (autograd would keep two such tensors of every chunk of
    every layer a remat block recomputes)."""

    @staticmethod
    def forward(ctx, cum, scores, xdt):
        ctx.save_for_backward(cum, scores, xdt)
        rep = xdt.shape[2] // scores.shape[2]
        causal = _causal(xdt.shape[3], xdt.device)
        return torch.stack([
            _masked_scores(cum[:, c], scores[:, c], rep, causal)[1]
            @ xdt[:, c] for c in range(xdt.shape[1])], 1)

    @staticmethod
    def backward(ctx, dy):
        cum, scores, xdt = ctx.saved_tensors
        Bsz, nc, H, Q, _ = xdt.shape
        G = scores.shape[2]
        rep = H // G
        causal = _causal(Q, xdt.device)
        d_cum, d_scores, d_xdt = [], [], []
        for c in range(nc):
            L, M = _masked_scores(cum[:, c], scores[:, c], rep, causal)
            dM = dy[:, c] @ xdt[:, c].transpose(-1, -2)          # (B, H, Q, Q)
            d_xdt.append(M.transpose(-1, -2) @ dy[:, c])
            d_scores.append((dM * L).view(Bsz, G, rep, Q, Q).sum(2))
            dD = dM * M                       # the gradient of cum_i - cum_j
            d_cum.append(dD.sum(-1) - dD.sum(-2))
        return (torch.stack(d_cum, 1), torch.stack(d_scores, 1),
                torch.stack(d_xdt, 1))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. xh (B, S, H, P); dt (B, S, H) positive; A (H,)
    negative; Bm / Cm (B, S, G, N). Returns y (B, S, H, P) and the final
    state (B, H, P, N), both fp32. The chunk is min(chunk, S), and S must
    be a multiple of it (the reference asserts so).

    What is per token or per chunk is computed for every chunk at once
    (the cumulative dA, the group scores C B^T, each chunk's contribution
    to the state it hands on); the carried h runs chunk by chunk, as the
    reference's scan carries it; the decay-masked (H, Q, Q) scores exist
    for one chunk at a time (``_IntraChunk``)."""
    Bsz, S, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"seq {S} not divisible by chunk {Q}")
    nc = S // Q
    # per head (B, nc, H, Q[, P]); per group (B, nc, G, Q, N)
    dA = (dt.float() * A).reshape(Bsz, nc, Q, H).transpose(2, 3)
    cum = torch.cumsum(dA, dim=-1)
    total = cum[..., -1:]
    xdt = (xh.float() * dt.float()[..., None]).reshape(
        Bsz, nc, Q, H, P).transpose(2, 3)
    Bq = Bm.float().reshape(Bsz, nc, Q, G, N).transpose(2, 3)
    Cq = Cm.float().reshape(Bsz, nc, Q, G, N).transpose(2, 3)
    scores = Cq @ Bq.transpose(-1, -2)                    # (B, nc, G, Q, Q)
    # chunk c's part of the state it hands on: sum_j exp(total - cum_j)
    # B_j xdt_j, (B, nc, H, P, N)
    wx = (xdt * torch.exp(total - cum)[..., None]).reshape(
        Bsz, nc, G, rep, Q, P)
    contrib = (wx.transpose(-1, -2) @ Bq[:, :, :, None]).reshape(
        Bsz, nc, H, P, N)
    decay = torch.exp(total)[..., None]                   # (B, nc, H, 1, 1)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0.float())
    before = []
    for d, add in zip(decay.unbind(1), contrib.unbind(1)):
        before.append(h)
        h = h * d + add
    h_in = torch.stack(before, 1).reshape(Bsz, nc, G, rep, P, N)
    # inter-chunk: y_i = exp(cum_i) C_i h_in; intra-chunk: _IntraChunk
    y = (Cq[:, :, :, None] @ h_in.transpose(-1, -2)).reshape(
        Bsz, nc, H, Q, P) * torch.exp(cum)[..., None]
    y = y + _IntraChunk.apply(cum, scores, xdt)
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P), h


def _decode(xh, dt, A, Bm, Cm, h):
    """The O(1) step of one token: h <- exp(dt A) h + dt B x; y = C h.
    xh (B, 1, H, P), dt (B, 1, H) fp32, Bm / Cm (B, 1, G, N). Returns y
    (B, 1, H, P) and h, fp32."""
    Bsz, _, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    dA = torch.exp(dt[:, 0] * A)                               # (B, H)
    xdt = xh[:, 0].float() * dt[:, 0, :, None]                 # (B, H, P)
    Bg = Bm[:, 0].float().repeat_interleave(rep, dim=1)        # (B, H, N)
    Cg = Cm[:, 0].float().repeat_interleave(rep, dim=1)
    h_new = h * dA[:, :, None, None] + xdt[..., None] * Bg[:, :, None, :]
    y = (h_new @ Cg[..., None])[..., 0]                        # (B, H, P)
    return y[:, None], h_new


def _apply_ssm_tp(x, p, cfg, tp):
    """``apply_ssm`` without a state on the rank's heads (the module's
    docstring)."""
    s = cfg.ssm
    Bsz, S, _ = x.shape
    d_inner, H = ssm_dims(cfg)
    P, G, N = s.head_dim, s.n_groups, s.state_dim
    if H % tp.size:
        raise ValueError(f"{cfg.name}: {H} SSM heads do not split over "
                         f"'model' ({tp.size})")
    Hl, rep = H // tp.size, H // G
    if Hl % rep and rep % Hl:
        raise ValueError(f"{cfg.name}: a rank's {Hl} SSM heads cut its "
                         f"groups of {rep}")
    ip, cw = p["in_proj"], p["conv_w"]
    tp.check_local(ip["x"], d_inner, -1, "in_proj/x")
    x = tpm.enter(x, tp, "ssm")
    z = x @ ip["z"]
    xs, _ = _causal_conv(x @ ip["x"], cw["x"])
    Bs, _ = _causal_conv(x @ tpm.enter(ip["B"], tp, "ssm.in_proj/B"),
                         tpm.enter(cw["B"], tp, "ssm.conv_w/B"))
    Cs, _ = _causal_conv(x @ tpm.enter(ip["C"], tp, "ssm.in_proj/C"),
                         tpm.enter(cw["C"], tp, "ssm.conv_w/C"))
    xh = xs.reshape(Bsz, S, Hl, P)
    Bm, Cm = Bs.reshape(Bsz, S, G, N), Cs.reshape(Bsz, S, G, N)
    if G > 1:
        # the groups of the rank's heads
        g0, g1 = tp.index * Hl // rep, -(-(tp.index + 1) * Hl // rep)
        Bm, Cm = Bm[:, :, g0:g1], Cm[:, :, g0:g1]
    dt = F.softplus((x @ ip["dt"]).float() + p["dt_bias"])    # (B, S, Hl)
    A = -torch.exp(p["A_log"])
    y, _ = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    y = y + xh.float() * p["skip_d"][:, None]
    scale = tp.narrow(tpm.enter(p["norm_scale"], tp, "ssm.norm_scale"))
    y = tpm.rms_norm(y.reshape(Bsz, S, d_inner // tp.size).to(x.dtype),
                     scale, d_inner, tp, "ssm.norm")
    out = (y * F.silu(z)) @ p["out_proj"]
    return tpm.leave(out, tp, "ssm.out_proj").to(x.dtype), None


def apply_ssm(x: torch.Tensor, p: dict, cfg, *,
              state: Optional[SSMState] = None, tp=None
              ) -> Tuple[torch.Tensor, Optional[SSMState]]:
    """Mamba-2 block, x (B, S, D). With `state` (prefill or decode) the
    new state is written into its tensors and returned; S == 1 with a
    state is the O(1) decode step. Under `tp` the heads are split over
    "model" (the module's docstring)."""
    if tp is not None:
        if state is not None:
            raise NotImplementedError(
                "an SSM state under a mesh: serving under a mesh is not "
                "ported (ROADMAP Queue 1 item 1)")
        return _apply_ssm_tp(x, p, cfg, tp)
    s = cfg.ssm
    Bsz, S, _ = x.shape
    d_inner, H = ssm_dims(cfg)
    P, G, N = s.head_dim, s.n_groups, s.state_dim
    ip, cw = p["in_proj"], p["conv_w"]
    z = x @ ip["z"]
    xs, new_cx = _causal_conv(x @ ip["x"], cw["x"],
                              None if state is None else state.conv_x)
    Bs, new_cb = _causal_conv(x @ ip["B"], cw["B"],
                              None if state is None else state.conv_B)
    Cs, new_cc = _causal_conv(x @ ip["C"], cw["C"],
                              None if state is None else state.conv_C)
    xh = xs.reshape(Bsz, S, H, P)
    Bm, Cm = Bs.reshape(Bsz, S, G, N), Cs.reshape(Bsz, S, G, N)
    dt = F.softplus((x @ ip["dt"]).float() + p["dt_bias"])    # (B, S, H)
    A = -torch.exp(p["A_log"])                                # (H,) < 0
    if S == 1 and state is not None:
        y, h = _decode(xh, dt, A, Bm, Cm, state.h)
    else:
        y, h = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk,
                           None if state is None else state.h)
    y = y + xh.float() * p["skip_d"][:, None]
    y = layers.rms_norm(y.reshape(Bsz, S, d_inner).to(x.dtype),
                        p["norm_scale"])
    out = (y * F.silu(z)) @ p["out_proj"]
    if state is not None:
        for dst, src in zip(state, (new_cx, new_cb, new_cc, h)):
            dst.copy_(src)
    return out.to(x.dtype), state
