"""Dynamic Mode Decomposition of weight trajectories, in Gram form.

With snapshots stored row-major ``S in R^{m x n}`` and the anchored data
``D`` (DESIGN.md §2), every m x m object of the DMD solve comes from the one
Gram ``G = D D^T``:

    X^T X = G[:-1, :-1],   X^T Z = G[:-1, 1:],   X^T d_last = G[:-1, -1]
    Atilde = Sigma^-1 V^T (X^T Z) V Sigma^-1                (reduced Koopman)
    w(m-1+s) = S^T c

so only the Gram (or its streaming rows) and the combine ``S^T c`` touch the
n-sized data; ``dmd_coefficients`` is O(m^3) algebra on (n_sys, m, m)
batches, run on the Gram's own device apart from one step: the
symmetric eigendecomposition of X^T X (``_lag_eigh``) runs on the host's
LAPACK for a Gram on either device.

Both modes of the operator power are here. ``mode="matpow"`` raises
Atilde to the s-th power by binary exponentiation on the device.
``mode="eig"`` (the paper's classic DMD) diagonalises Atilde: one explicit
host step per call (the reference's ``pure_callback``) copies the
(batch, m-1, m-1) operator to the host, runs ``numpy.linalg.eig`` in its
dtype (float32 in, complex64 out) and copies the eigenpairs back; the
reconstruction ``Y Lambda^s Y^-1`` (a complex64 solve), the matpow
fallback of the defective-operator guard and the selection between them
stay on the operator's device. Both modes take the affine augmentation,
trust region, relax, energy rank, absolute sigma floor, Tikhonov ridge,
and the controller's dynamic horizon and ridge (``s_dyn``, ``ridge_dyn``:
tensors; in matpow mode the coefficients are differentiable in them and
in ``relax``, which the controller's meta-tuning backpropagates through;
the host eig has no derivative). ``dmd_eigenvalues(_from_gram)`` are the
host float64 spectral diagnostics.

Both host steps (``_lag_eigh``, "eigh", and ``_host_eig_step``, "eig") are
opaque ops of the audit's recorder: its solve-budget pass counts the
systems a jump solves from their input stacks' batch rows.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch.kernels.device import opaque

# eig mode's host round trips since the last reset_eig_stats(): calls
# (one device-to-host copy of the operator stack and one copy back each),
# the systems they solved, and per call a device tensor of how many of
# those the defective-operator guard sent to the matpow fallback (read on
# the host only by eig_stats(), so a jump never waits on it)
HOST_EIG = {"calls": 0, "systems": 0}
_FALLBACKS: List[torch.Tensor] = []


def reset_eig_stats() -> None:
    HOST_EIG.update(calls=0, systems=0)
    _FALLBACKS.clear()


def eig_stats() -> dict:
    """The eig-mode counters, with the guard's fallbacks summed (one host
    read per recorded call)."""
    return {**HOST_EIG, "fallbacks": sum(int(t) for t in _FALLBACKS)}


def _systems(x: torch.Tensor, stack_dims: int):
    """(m, stack..., rest...) -> fp32 (m, S, n) and the stack shape. The
    callers contract each system's (m, n) slice with a 2-D product, as the
    reference contracts each leaf."""
    stack = tuple(x.shape[1:1 + stack_dims])
    n_sys = 1
    for d in stack:
        n_sys *= int(d)
    return x.float().reshape(x.shape[0], n_sys, -1), stack


def gram_matrix(snapshots: torch.Tensor, anchor: str = "none",
                stack_dims: int = 0, upcast: bool = True) -> torch.Tensor:
    """(m, stack..., param...) -> (stack..., m, m) fp32 ``D D^T`` over the
    trailing axes, one Gram per stacked system (the oracle for the
    kernels, and the route of mean-anchored and ``dot_general`` leaves).

    ``upcast=False`` (bf16 buffers) anchors in the storage dtype and then
    contracts in fp32, as the reference's bf16 x bf16 -> fp32 product does:
    a product of two bf16 values is exact in fp32."""
    x = snapshots.float() if upcast else snapshots
    if anchor == "first":
        x = x - x[:1]
    elif anchor == "mean":
        x = x - x.float().mean(dim=0, keepdim=True).to(x.dtype)
    elif anchor != "none":
        raise ValueError(f"unknown anchor {anchor!r}")
    xs, stack = _systems(x, stack_dims)
    m = xs.shape[0]
    return torch.stack([d @ d.T for d in xs.unbind(1)]).reshape(
        stack + (m, m))


def gram_row_matrix(snapshots: torch.Tensor, p: torch.Tensor,
                    anchor: str = "none", stack_dims: int = 0,
                    upcast: bool = True) -> torch.Tensor:
    """(stack..., m) streaming Gram row ``<d_p, d_j>`` for every buffer row
    j of every stacked system. When `p` is the new anchor (slot 0 just
    rewritten) the row is exactly zero."""
    x = snapshots.float() if upcast else snapshots
    q = p.float() if upcast else p.to(x.dtype)
    if anchor == "first":
        q = q - x[0]
        x = x - x[:1]
    elif anchor != "none":
        raise ValueError(f"streaming gram does not support anchor {anchor!r}")
    xs, stack = _systems(x, stack_dims)
    qs = q.float().reshape(xs.shape[1], -1)
    return torch.stack([d @ v for d, v in zip(xs.unbind(1), qs)]).reshape(
        stack + xs.shape[:1])


def combine_snapshots(snapshots: torch.Tensor, c: torch.Tensor,
                      stack_dims: int = 0, upcast: bool = True
                      ) -> torch.Tensor:
    """w = S^T c in fp32: (m, stack..., param...) x (stack..., m) ->
    (stack..., param...), one coefficient row per stacked system.
    ``upcast=False`` rounds c to the buffer's dtype first, as the
    reference does."""
    x = snapshots.float() if upcast else snapshots
    cf = c.float() if upcast else c.to(x.dtype)
    xs, _ = _systems(x, stack_dims)
    cs = cf.float().reshape(xs.shape[1], -1)
    w = torch.stack([v @ d for v, d in zip(cs, xs.unbind(1))])
    return w.reshape(snapshots.shape[1:])


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


def _mean_in_order(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis rounded as the reference's XLA reduce
    rounds it: an fp32 sum from the first element to the last, times the
    fp32 reciprocal of the count. ``torch.mean`` sums in another order,
    and one ulp of the affine shift moves the eigenvalues the rank mask
    reads (``_lag_eigh``)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc * torch.tensor(1.0 / x.shape[-1], dtype=x.dtype,
                              device=x.device)


@opaque("eigh", kind="host")
def _lag_eigh(g_lag: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenpairs (ascending) of a (batch, k, k) stack of lag Grams X^T X,
    by the host's LAPACK (``torch.linalg.eigh`` on the CPU) for a stack on
    either device.

    The rank mask compares eigenvalue ratios down to tol^2 (1e-8 at the
    benches' tol 1e-4), under fp32's 1.2e-7, so which modes it keeps is
    decided by the solver's rounding. LAPACK's divide and conquer
    (``syevd``, also the reference's CPU ``jnp.linalg.eigh``) errs by ~eps
    * lambda_max either way and drops about half of those modes; cuSOLVER's
    fp32 solvers (``torch.linalg.eigh`` on the card) resolve them and keep
    them, so that s = 55 powers their 1/sigma into jumps of 52-1117x the
    loss in every unguarded fig4 run on the card, where the host's solve
    stays under 5.1x (``examples/torch_noise_floor.py --case card``). On the host a stack on
    the card is solved to the same bits as on the CPU. One device round
    trip per solve: no CUDA graph may capture it, and the result has no
    derivative (the Gram never needs one)."""
    if not g_lag.is_cuda:
        return torch.linalg.eigh(g_lag)
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("the DMD solve's host eigh cannot run inside a "
                           "CUDA graph capture: run the jump step eagerly")
    w, v = torch.linalg.eigh(g_lag.detach().cpu())
    return w.to(g_lag.device), v.to(g_lag.device)


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


def _ridge_inv_sigma(sigma: torch.Tensor, mask: torch.Tensor, ridge
                     ) -> torch.Tensor:
    """Tikhonov-shrunk pseudo-inverse factor sigma / (sigma^2 + lambda),
    lambda = ridge * sigma_max^2 (relative, so the solve is
    scale-equivariant). `ridge` is a float or a tensor (the controller's
    meta-tuned value, differentiable)."""
    smax = sigma.amax(dim=-1, keepdim=True)
    if isinstance(ridge, torch.Tensor):
        lam = torch.clamp_min(ridge.float(), 0.0) * smax * smax
    else:
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


def _matrix_power_traced(a: torch.Tensor, s: torch.Tensor, s_max: int
                         ) -> torch.Tensor:
    """a^s for an integer tensor s in [1, s_max] (a scalar, or one entry per
    system of `a`'s batch): binary exponentiation over the static bits of
    s_max, each bit's factor taken or skipped by a select, as the
    reference's unrolled chain does. Nothing is read back to the host."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand(
        a.shape)
    s = s.to(torch.int32)
    result, base = eye, a
    nbits = max(int(s_max).bit_length(), 1)
    for bit in range(nbits):
        take = ((s >> bit) & 1).bool()
        if take.dim():
            take = take[..., None, None]
        result = torch.where(take, result @ base, result)
        if bit + 1 < nbits:
            base = base @ base
    return result


def _complex_int_pow(x: torch.Tensor, s: int) -> torch.Tensor:
    """x^s elementwise for a static integer s >= 1 by repeated squaring, in
    the order XLA expands the reference's ``lam ** int(s)``."""
    acc = None
    while s > 0:
        if s & 1:
            acc = x if acc is None else acc * x
        s >>= 1
        if s > 0:
            x = x * x
    return acc


def _host_eig(a: np.ndarray) -> np.ndarray:
    """The host half of eig mode, the reference's ``_host_eig``: numpy's
    eig of each (k, k) operator in its dtype and the rcond of its
    eigenvector matrix (~0 for a defective, Jordan-block operator, whose
    reconstruction is meaningless). Packed into ONE complex64 array
    (batch, k + 1, k + 1) for the single copy back: eigenvectors in
    [:k, :k], eigenvalues in row k, rcond in column k. numpy refuses a
    non-finite matrix (the reference's callback then raises); such a
    system gets NaN eigenpairs and rcond 0 here, so the guard hands it to
    the matpow fallback and the coefficient guard to ``c = e_last``."""
    finite = np.isfinite(a).all(axis=(-2, -1))
    w, v = np.linalg.eig(np.where(finite[..., None, None], a, 0))
    sv = np.linalg.svd(v, compute_uv=False)
    rcond = (sv[..., -1] / np.maximum(sv[..., 0], 1e-300)).astype(np.float32)
    k = a.shape[-1]
    out = np.zeros(a.shape[:-2] + (k + 1, k + 1), np.complex64)
    out[..., :k, :k] = v.astype(np.complex64)
    out[..., k, :k] = w.astype(np.complex64)
    out[..., k, k] = rcond
    out[~finite, :k + 1, :k] = np.nan
    out[~finite, k, k] = 0
    return out


@opaque("eig", kind="host")
def _host_eig_step(atilde: torch.Tensor) -> torch.Tensor:
    """eig mode's host step: the operator stack copied to the host,
    ``_host_eig`` there, the packed eigenpairs copied back."""
    return torch.from_numpy(_host_eig(atilde.detach().cpu().numpy())).to(
        atilde.device)


def _eig_power(atilde: torch.Tensor, s, clamp_eigs: bool, s_max: int
               ) -> torch.Tensor:
    """Atilde^s via its eigendecomposition, batched over (batch, k, k),
    with the reference's defective-operator guard.

    The host step: one copy of the operator stack to the host, numpy's
    eig there (``_host_eig``), one copy back. Everything else runs on
    Atilde's device. ``clamp_eigs`` clamps only |lambda| > 1 + 1e-3 onto
    the unit circle (a defective lambda = 1 pair splits into 1 +- delta
    under fp32 noise with huge opposing amplitudes; clamping one of them
    would break their cancellation). The guard reconstructs the UNCLAMPED
    power through the eigenbasis and compares it with the matpow power of
    the same operator: the eig result is used where it is finite and
    either validates (relative error < 1e-2 and rcond > 1e-7) or the
    matpow power is itself non-finite (an explosive operator whose
    unclamped power overflows, the regime the clamp is for); else the
    matpow power. A zero eigenvalue's power is exactly 0. `s` is a static
    int, or an integer tensor (the controller's horizon; a scalar or one
    per system) in [1, s_max]: then lambda^s goes through the complex
    power and the fallback through the masked chain over s_max's bits.

    The host step cannot run inside a CUDA graph capture (it reads the
    device): the jump step that calls it runs eagerly."""
    if atilde.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("eig mode's host eig cannot run inside a CUDA "
                           "graph capture: run the jump step eagerly")
    k = atilde.shape[-1]
    packed = _host_eig_step(atilde)
    eigvecs = packed[..., :k, :k]
    eigvals = packed[..., k, :k]
    rcond = packed[..., k, k].real
    HOST_EIG["calls"] += 1
    HOST_EIG["systems"] += int(np.prod(atilde.shape[:-2], dtype=np.int64))

    if clamp_eigs:
        mag = eigvals.abs()
        lam_clamped = torch.where(mag > 1.0 + 1e-3,
                                  eigvals / torch.clamp_min(mag, 1e-30),
                                  eigvals)
    else:
        lam_clamped = eigvals

    static = isinstance(s, (int, np.integer))
    if static:
        fallback = _matrix_power(atilde, int(s))
    else:
        fallback = _matrix_power_traced(atilde, s, int(s_max))
        s_c = s.to(torch.float32).to(torch.complex64)
        if s_c.dim():                       # one horizon per system
            s_c = s_c.reshape(-1, 1)

    def reconstruct(lam):
        nz = lam.abs() > 0
        lam_safe = torch.where(nz, lam, torch.ones_like(lam))
        lam_s = (_complex_int_pow(lam_safe, int(s)) if static
                 else torch.pow(lam_safe, s_c))
        lam_s = torch.where(nz, lam_s, torch.zeros_like(lam_s))
        # Y Lambda^s Y^-1 as a solve against Y^T; solve_ex: a singular Y
        # (a defective operator) gives non-finite values for the guard to
        # catch, not an error, and no host read
        m_complex = eigvecs * lam_s[..., None, :]
        sol = torch.linalg.solve_ex(eigvecs.transpose(-1, -2),
                                    m_complex.transpose(-1, -2))[0]
        return sol.transpose(-1, -2).real

    m_full = reconstruct(lam_clamped)
    m_check = reconstruct(eigvals) if clamp_eigs else m_full

    def norm(x):
        return torch.sqrt(torch.sum(torch.square(x), dim=(-2, -1)))
    rel_err = norm(m_check - fallback) / torch.clamp_min(norm(fallback),
                                                         1e-30)
    eig_finite = torch.isfinite(m_full).all(dim=-1).all(dim=-1)
    fb_finite = torch.isfinite(fallback).all(dim=-1).all(dim=-1)
    validated = (rel_err < 1e-2) & (rcond > 1e-7)
    use_eig = eig_finite & (validated | ~fb_finite)
    _FALLBACKS.append((~use_eig).sum())
    return torch.where(use_eig[..., None, None], m_full, fallback)


def _matvec(mat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", mat, vec)


def dmd_coefficients(gram: torch.Tensor, *, s: int, tol: float = 1e-10,
                     mode: str = "matpow", clamp_eigs: bool = False,
                     anchor: str = "none",
                     affine: bool = False, trust_region: float = 0.0,
                     relax: float = 1.0, energy: float = 0.0,
                     atol: float = 0.0, ridge: float = 0.0,
                     s_dyn=None, ridge_dyn=None
                     ) -> Tuple[torch.Tensor, dict]:
    """Coefficients c (..., m) such that w_extrapolated = S^T c.

    ``gram`` is (..., m, m) fp32 ``D D^T`` with D anchored as ``anchor``
    says; the returned c is over the ORIGINAL snapshot rows (the anchor is
    folded back in). ``mode`` is "matpow" or "eig" (``_eig_power``, with
    ``clamp_eigs``; its power is masked to the kept modes). ``s`` is the
    horizon, ``trust_region > 0`` caps the
    jump at tr * s * rms_step, ``relax`` blends w <- (1-relax) w_last +
    relax w_dmd, ``energy``/``atol``/``ridge`` shape the rank mask and the
    regression factor. ``s_dyn`` (controller mode: an integer tensor, the
    adapted horizon) replaces ``s``, clamped into [1, s]: ``s`` stays the
    static cap that sizes the power chain. ``ridge_dyn`` (a tensor, the
    meta-tuned ridge) takes precedence over ``ridge``. Returns (c, info)
    with info's rank, sigma_ratio, jump_scale, jump_norm and step_rms."""
    if mode not in ("matpow", "eig"):
        raise ValueError(f"unknown DMD mode {mode!r}")
    m = gram.shape[-1]
    if m < 3:
        raise ValueError("DMD needs at least 3 snapshots (m >= 3)")
    # always one (batch, m, m) stack: a 2-D matmul on the CPU rounds
    # differently from the batched one, and the per-leaf and arena routes
    # must solve the same Gram to the same bits
    lead = gram.shape[:-2]
    gram = gram.reshape(-1, m, m)
    raw_gram = gram
    if affine:
        # rank-one Gram update G + gamma^2 1 1^T, gamma^2 = mean(diag(G))
        diag = torch.diagonal(gram, dim1=-2, dim2=-1)
        gamma2 = torch.clamp_min(_mean_in_order(diag), 1e-30)
        gram = gram + gamma2[..., None, None]
    g_lag = gram[..., :-1, :-1]                  # X^T X
    g_cross = gram[..., :-1, 1:]                 # X^T Z
    g_last = gram[..., :-1, -1]                  # X^T d_last

    # LAPACK misbehaves on a non-finite matrix where XLA returns garbage;
    # either way the final guard below turns c into e_last, so hand eigh
    # a finite stand-in
    g_lag = torch.where(torch.isfinite(g_lag), g_lag,
                        torch.zeros_like(g_lag))
    eigvals, v = _lag_eigh(g_lag)                # ascending; batched
    sigma, inv_sigma, mask = _masked_inv_sigma(eigvals, tol, energy, atol)
    vt = v.transpose(-1, -2)
    if ridge_dyn is not None:
        inv_fit = _ridge_inv_sigma(sigma, mask, ridge_dyn)
    elif ridge and ridge > 0:
        inv_fit = _ridge_inv_sigma(sigma, mask, ridge)
    else:
        inv_fit = inv_sigma
    vt_c_v = vt @ g_cross @ v
    atilde = (inv_sigma[..., :, None] * vt_c_v) * inv_fit[..., None, :]
    if s_dyn is None:
        s_val = int(s)
    else:
        s_val = torch.clamp(torch.as_tensor(s_dyn, device=gram.device)
                            .to(torch.int32), 1, int(s))
        if s_val.dim():                   # one horizon per system
            s_val = s_val.reshape(-1)
    if mode == "eig":
        atilde_s = _eig_power(atilde, s_val, clamp_eigs, int(s))
        atilde_s = torch.where(mask[..., :, None] & mask[..., None, :],
                               atilde_s, torch.zeros_like(atilde_s))
    elif s_dyn is None:
        atilde_s = _matrix_power(atilde, s_val)
    else:
        atilde_s = _matrix_power_traced(atilde, s_val, int(s))

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
    return c.reshape(lead + (m,)), {k: v.reshape(lead)
                                    for k, v in info.items()}


def dmd_extrapolate(snapshots: torch.Tensor, *, s: int, tol: float = 1e-10,
                    mode: str = "matpow", clamp_eigs: bool = False,
                    anchor: str = "none",
                    affine: bool = False, trust_region: float = 0.0,
                    relax: float = 1.0, atol: float = 0.0,
                    ridge: float = 0.0) -> Tuple[torch.Tensor, dict]:
    """One-leaf convenience wrapper: snapshots (m, ...) -> the extrapolated
    (...) in fp32, and the coefficient info. A non-finite snapshot poisons
    the combine even under the c = e_last guard (0 * inf = NaN), so it
    never returns less finite than the last snapshot."""
    gram = gram_matrix(snapshots, anchor=anchor)
    c, info = dmd_coefficients(gram, s=s, tol=tol, mode=mode,
                               clamp_eigs=clamp_eigs, anchor=anchor,
                               affine=affine, trust_region=trust_region,
                               relax=relax, atol=atol, ridge=ridge)
    w = combine_snapshots(snapshots, c)
    return torch.where(torch.isfinite(w), w,
                       snapshots[-1].to(w.dtype)), info


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def dmd_eigenvalues_from_gram(gram, *, tol: float = 1e-10) -> np.ndarray:
    """Spectral diagnostics on the host, in float64, from one (m, m) Gram
    alone: the Koopman eigenvalues of the reduced operator the next jump
    would fit (complex128, one per kept mode). The Gram must already be in
    the anchored form its caller maintains (the carried streaming Gram, or
    a bucket's segment-summed one)."""
    g_np = _host64(gram)
    g_lag, g_cross = g_np[:-1, :-1], g_np[:-1, 1:]
    lam, v = np.linalg.eigh(g_lag)
    sig = np.sqrt(np.maximum(lam, 0.0))
    mask = sig > tol * max(sig.max(), 1e-300)
    if not mask.any():
        return np.zeros(0, np.complex128)
    inv = np.where(mask, 1.0 / np.where(mask, sig, 1.0), 0.0)
    atilde = (inv[:, None] * (v.T @ g_cross @ v)) * inv[None, :]
    atilde = atilde[np.ix_(mask, mask)]
    return np.linalg.eigvals(atilde)


def dmd_eigenvalues(snapshots, *, tol: float = 1e-10,
                    anchor: str = "none") -> np.ndarray:
    """Spectral diagnostics on the host: the DMD eigenvalues of an (m, ...)
    snapshot trajectory, in float64."""
    s_np = _host64(snapshots)
    s_np = s_np.reshape(s_np.shape[0], -1)
    if anchor == "first":
        s_np = s_np - s_np[:1]
    elif anchor == "mean":
        s_np = s_np - s_np.mean(axis=0, keepdims=True)
    return dmd_eigenvalues_from_gram(s_np @ s_np.T, tol=tol)
