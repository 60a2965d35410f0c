"""Dynamic Mode Decomposition of weight trajectories, in Gram form.

With snapshots stored row-major ``S in R^{m x n}`` and the anchored data
``D`` (DESIGN.md §2), every m x m object of the DMD solve comes from the one
Gram ``G = D D^T``:

    X^T X = G[:-1, :-1],   X^T Z = G[:-1, 1:],   X^T d_last = G[:-1, -1]
    Atilde = Sigma^-1 V^T (X^T Z) V Sigma^-1                (reduced Koopman)
    w(m-1+s) = S^T c

so only the Gram (or its streaming rows) and the combine ``S^T c`` touch the
n-sized data; ``dmd_coefficients`` is O(m^3) algebra on (n_sys, m, m)
batches, run on the Gram's own device.

Ported: matpow mode with the affine augmentation, trust region, relax,
energy rank, absolute sigma floor and Tikhonov ridge. Not yet ported (they
raise ``NotImplementedError``): eig mode and the controller's dynamic
horizon / ridge (ROADMAP Queue 1).
"""
from __future__ import annotations

from typing import Tuple

import torch


def gram_matrix(snapshots: torch.Tensor, anchor: str = "none"
                ) -> torch.Tensor:
    """(m, ...) -> (m, m) fp32 ``D D^T`` over the flattened trailing axes
    (the oracle for the arena kernels)."""
    x = snapshots.float().reshape(snapshots.shape[0], -1)
    if anchor == "first":
        x = x - x[:1]
    elif anchor == "mean":
        x = x - x.mean(dim=0, keepdim=True)
    elif anchor != "none":
        raise ValueError(f"unknown anchor {anchor!r}")
    return x @ x.T


def gram_row_matrix(snapshots: torch.Tensor, p: torch.Tensor,
                    anchor: str = "none") -> torch.Tensor:
    """(m,) streaming Gram row ``<d_p, d_j>`` for every buffer row j."""
    x = snapshots.float().reshape(snapshots.shape[0], -1)
    q = p.float().reshape(-1)
    if anchor == "first":
        q = q - x[0]
        x = x - x[:1]
    elif anchor != "none":
        raise ValueError(f"streaming gram does not support anchor {anchor!r}")
    return x @ q


def set_gram_row(gram: torch.Tensor, row: torch.Tensor, slot: int
                 ) -> torch.Tensor:
    """Write `row` into row AND column `slot` of a (..., m, m) Gram, in
    place (the Gram is carried state; writing in place saves a copy per
    record), and return it. This is the cyclic-slot invalidation: the
    evicted snapshot's row and column are overwritten in one go."""
    row = row.to(gram.dtype)
    gram[..., slot, :] = row
    gram[..., :, slot] = row
    return gram


def _masked_inv_sigma(eigvals: torch.Tensor, tol: float, energy: float = 0.0,
                      atol: float = 0.0):
    """Eigenvalues of X^T X (ascending; batched) -> sigma, 1/sigma, mask.

    ``energy == 0``: keep sigma_r / sigma_0 > tol. ``energy > 0``: keep the
    smallest leading set of modes whose cumulative eigenvalue energy reaches
    that fraction, with a 1e-6 * sigma_max floor. ``atol > 0`` adds an
    absolute sigma floor to either policy."""
    lam = torch.clamp_min(eigvals, 0.0)
    sigma = torch.sqrt(lam)
    smax = sigma.amax(dim=-1, keepdim=True)
    if energy and energy > 0:
        lam_desc = torch.flip(lam, [-1])
        cum = torch.cumsum(lam_desc, dim=-1)
        total = cum[..., -1:]
        keep = (cum - lam_desc) < energy * torch.clamp_min(total, 1e-30)
        mask = torch.flip(keep, [-1]) & (
            sigma > 1e-6 * torch.clamp_min(smax, 1e-30))
    else:
        mask = sigma > tol * torch.clamp_min(smax, 1e-30)
    if atol and atol > 0:
        mask = mask & (sigma > atol)
    one = torch.ones_like(sigma)
    inv = torch.where(mask, 1.0 / torch.where(mask, sigma, one),
                      torch.zeros_like(sigma))
    return sigma, inv, mask


def _ridge_inv_sigma(sigma: torch.Tensor, mask: torch.Tensor, ridge: float
                     ) -> torch.Tensor:
    """Tikhonov-shrunk pseudo-inverse factor sigma / (sigma^2 + lambda),
    lambda = ridge * sigma_max^2 (relative, so the solve is
    scale-equivariant)."""
    smax = sigma.amax(dim=-1, keepdim=True)
    lam = max(float(ridge), 0.0) * smax * smax
    return torch.where(mask, sigma / (sigma * sigma + lam),
                       torch.zeros_like(sigma))


def _matrix_power(a: torch.Tensor, s: int) -> torch.Tensor:
    """a^s for integer s >= 1 by binary exponentiation, in the reference's
    multiplication order."""
    if s < 1:
        raise ValueError(f"matrix power needs s >= 1 (got {s})")
    result = None
    base = a
    k = s
    while k > 0:
        if k & 1:
            result = base if result is None else result @ base
        k >>= 1
        if k == 0:
            break
        base = base @ base
    return result


def _matvec(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", mat, vec)


def dmd_coefficients(gram: torch.Tensor, *, s: int, tol: float = 1e-10,
                     mode: str = "matpow", anchor: str = "none",
                     affine: bool = False, trust_region: float = 0.0,
                     relax: float = 1.0, energy: float = 0.0,
                     atol: float = 0.0, ridge: float = 0.0,
                     s_dyn=None, ridge_dyn=None
                     ) -> Tuple[torch.Tensor, dict]:
    """Coefficients c (..., m) such that w_extrapolated = S^T c.

    ``gram`` is (..., m, m) fp32 ``D D^T`` with D anchored as ``anchor``
    says; the returned c is over the ORIGINAL snapshot rows (the anchor is
    folded back in). ``s`` is the horizon, ``trust_region > 0`` caps the
    jump at tr * s * rms_step, ``relax`` blends w <- (1-relax) w_last +
    relax w_dmd, ``energy``/``atol``/``ridge`` shape the rank mask and the
    regression factor. Returns (c, info) with info's rank, sigma_ratio,
    jump_scale, jump_norm and step_rms."""
    if mode != "matpow":
        raise NotImplementedError(
            f"DMD mode {mode!r} is not ported yet (ROADMAP Queue 1: eig "
            "mode and bucket scope); use mode='matpow'")
    if s_dyn is not None or ridge_dyn is not None:
        raise NotImplementedError(
            "dynamic horizon / ridge (controller mode) is not ported yet "
            "(ROADMAP Queue 1: controller and Trainer)")
    m = gram.shape[-1]
    if m < 3:
        raise ValueError("DMD needs at least 3 snapshots (m >= 3)")
    raw_gram = gram
    if affine:
        # rank-one Gram update G + gamma^2 1 1^T, gamma^2 = mean(diag(G))
        diag = torch.diagonal(gram, dim1=-2, dim2=-1)
        gamma2 = torch.clamp_min(diag.mean(dim=-1), 1e-30)
        gram = gram + gamma2[..., None, None]
    g_lag = gram[..., :-1, :-1]                  # X^T X
    g_cross = gram[..., :-1, 1:]                 # X^T Z
    g_last = gram[..., :-1, -1]                  # X^T d_last

    # LAPACK/cuSOLVER raise on a non-finite matrix where XLA returns
    # garbage; either way the final guard below turns c into e_last, so
    # hand eigh a finite stand-in
    g_lag = torch.where(torch.isfinite(g_lag), g_lag,
                        torch.zeros_like(g_lag))
    eigvals, v = torch.linalg.eigh(g_lag)        # ascending; batched
    sigma, inv_sigma, mask = _masked_inv_sigma(eigvals, tol, energy, atol)
    vt = v.transpose(-1, -2)
    inv_fit = (_ridge_inv_sigma(sigma, mask, ridge) if ridge and ridge > 0
               else inv_sigma)
    vt_c_v = vt @ g_cross @ v
    atilde = (inv_sigma[..., :, None] * vt_c_v) * inv_fit[..., None, :]
    atilde_s = _matrix_power(atilde, int(s))

    b = inv_sigma * _matvec(vt, g_last)          # U^T d_last
    y = _matvec(atilde_s, b)
    c_main = _matvec(v, inv_sigma * y)           # (..., m-1)
    c = torch.cat([c_main, torch.zeros_like(c_main[..., :1])], dim=-1)

    e_last = torch.zeros_like(c)
    e_last[..., -1] = 1.0

    # jump-length diagnostics from the RAW (unaugmented) Gram
    d = c - e_last
    jump2 = torch.clamp_min(
        torch.einsum("...i,...ij,...j->...", d, raw_gram, d), 0.0)
    diag = torch.diagonal(raw_gram, dim1=-2, dim2=-1)
    sup = torch.diagonal(raw_gram, offset=1, dim1=-2, dim2=-1)
    step2 = (diag[..., 1:] + diag[..., :-1] - 2.0 * sup).mean(dim=-1)

    jump_scale = torch.ones_like(step2)
    if trust_region and trust_region > 0:
        radius2 = (trust_region * s) ** 2 * torch.clamp_min(step2, 0.0)
        jump_scale = torch.clamp_max(torch.sqrt(
            radius2 / torch.clamp_min(jump2, 1e-30)), 1.0)
        # any non-finite guard input collapses to the no-op jump c = e_last
        finite = (torch.isfinite(c).all(dim=-1) & torch.isfinite(jump2)
                  & torch.isfinite(step2) & torch.isfinite(jump_scale))
        jump_scale = torch.where(finite, jump_scale,
                                 torch.zeros_like(jump_scale))
        c = torch.where(finite[..., None], c, e_last)
        c = jump_scale[..., None] * c + (1.0 - jump_scale[..., None]) * e_last

    if anchor == "first":
        fold = 1.0 - c.sum(dim=-1)
        c = torch.cat([(c[..., 0] + fold)[..., None], c[..., 1:]], dim=-1)
    elif anchor == "mean":
        c = c + (1.0 - c.sum(dim=-1, keepdim=True)) / m

    relax_t = torch.as_tensor(relax, dtype=torch.float32, device=c.device)
    c = relax_t * c + (1.0 - relax_t) * e_last

    # never emit a non-finite combination, nor trust one from a non-finite
    # Gram: fall back to "keep w_last"
    ok = (torch.isfinite(c).all(dim=-1, keepdim=True)
          & torch.isfinite(raw_gram).all(dim=-1).all(dim=-1)[..., None])
    c = torch.where(ok, c, e_last)

    inf = torch.full_like(sigma, float("inf"))
    info = {
        "rank": mask.to(torch.int32).sum(dim=-1),
        "sigma_ratio": torch.where(mask, sigma, inf).amin(dim=-1)
                       / torch.clamp_min(sigma.amax(dim=-1), 1e-30),
        "jump_scale": jump_scale,
        "jump_norm": relax_t.abs() * jump_scale * torch.sqrt(torch.where(
            torch.isfinite(jump2), jump2, torch.zeros_like(jump2))),
        "step_rms": torch.sqrt(torch.clamp_min(torch.where(
            torch.isfinite(step2), step2, torch.zeros_like(step2)), 0.0)),
    }
    return c, info
