"""The paper's dataset (Appendix 1): dispersion of a reactive pollutant in the
atmosphere, computed from its equations.

Pipeline (the reference's ``repro/data/pollutant.py``, whose numpy pieces
are copied here so both packages see the same numbers):

  1. Blasius boundary layer with slip, 2f''' + f'' f = 0, f'(0) = uh/U0,
     f(0) = -2uv/sqrt(nu U0), f'(inf) = 1, solved by shooting on f''(0)
     (RK4, bracket doubling, 60 bisection steps) on the host in float64
     numpy, vectorised over samples (``solve_blasius_batch``). Each sample
     gives the same bits as a scalar solve of it.
  2. The velocity field u_x = U0 f'(eta), u_y = 0.5 sqrt(nu U0 / x)
     (eta f' - f), eta = y sqrt(U0 / (2 nu x)), on the host per sample.
  3. The steady advection-diffusion-reaction system for (c1, c2, c3),
     marched in pseudo-time with a per-cell step (upwind advection,
     central diffusion, explicit reaction) in torch on the device, every
     sample at once (``march``): each sample stops at its own iteration,
     as under the reference's ``vmap`` of a ``while_loop``, so a sample's
     result does not depend on the batch it is marched in.
  4. c3 bilinearly sampled at 2670 probe points on the host, inputs and
     outputs normalised (numpy, as the reference).

Boundary conditions: inflow c = 0 at x = 0, outflow dc/dx = 0 at x = Lx,
Neumann at the terrain (y = 0) and the top. Sources: discs of radius 0.5 at
(0.1, 0.1) and (0.1, 0.3) with strength 0.1 (paper eq. 9).
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple

import numpy as np
import torch

from repro_torch.kernels.device import resolve_device

NU = 1e-5                       # kinematic viscosity of air (paper)

PARAM_RANGES = {
    "K12": (1.0, 20.0),
    "K3": (0.0, 10.0),
    "D": (0.01, 0.5),
    "U0": (0.01, 2.0),
    "uh": (-0.2, 0.2),
    "uv": (-0.2, 0.2),
}
PARAM_ORDER = ("K12", "K3", "D", "U0", "uh", "uv")

# iterations marched between two host reads of "is any sample still
# active?" (a frozen sample's state no longer changes, so reading late is
# exact)
CHECK_EVERY = 64


# ---------------------------------------------------------------------------
# 1. Blasius with slip (shooting), vectorised over samples
# ---------------------------------------------------------------------------

def _blasius_integrate(fpp0, fp0, f0, eta_max: float = 10.0, n: int = 400,
                       traj: bool = False):
    """RK4 integrate [f, f', f''] with 2f''' = -f'' f for every sample of
    the (S,) arrays at once, in float64: the trajectory (n+1, 3, S) with
    `traj`, else the final state (3, S). Each sample's operations are the
    scalar reference's, in its order."""
    h = eta_max / n
    y = np.stack(np.broadcast_arrays(f0, fp0, fpp0)).astype(np.float64)

    def rhs(y):
        return np.stack([y[1], y[2], -0.5 * y[2] * y[0]])

    out = [y.copy()] if traj else None
    with np.errstate(all="ignore"):
        for _ in range(n):
            k1 = rhs(y)
            k2 = rhs(y + 0.5 * h * k1)
            k3 = rhs(y + 0.5 * h * k2)
            k4 = rhs(y + h * k3)
            y = y + (h / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
            y = np.clip(np.nan_to_num(y, nan=1e6, posinf=1e6, neginf=-1e6),
                        -1e6, 1e6)
            if traj:
                out.append(y.copy())
    return np.stack(out) if traj else y


def _shoot(fpp0, fp0, f0, eta_max, n):
    val = _blasius_integrate(fpp0, fp0, f0, eta_max, n)[1] - 1.0
    return np.clip(np.nan_to_num(val, nan=10.0), -10.0, 10.0)


def solve_blasius_batch(U0, uh, uv, eta_max: float = 10.0, n: int = 400):
    """Shooting on f''(0) so that f'(eta_max) = 1, for every sample of the
    (S,) arrays at once. Returns (eta (n+1,), f (S, n+1), fp (S, n+1)).

    Per sample this is the reference's scalar ``solve_blasius`` bit for
    bit: the slip values in the params' own dtype (float32 for the
    dataset's params, as NumPy 2 promotes the scalar code), then float64;
    bracket doubling (at most 12 tries, masked per sample), 60 bisection
    steps on ``fa * fm <= 0``, and f''(0) = 0.4696 where no bracket is
    found. (The scalar code's ``max(U0, 1e-8)`` leaves float32 only for
    U0 < 1e-8, outside the parameter box.)"""
    U0, uh, uv = (np.atleast_1d(np.asarray(v)) for v in (U0, uh, uv))
    # slip BCs per Appendix 1, clipped to the regime where the self-similar
    # profile stays physical (the reference's comment at this point)
    u0 = np.maximum(U0, 1e-8)
    fp0 = np.clip(uh / u0, -0.5, 1.5)
    f0 = np.clip(-2.0 * uv / np.sqrt(NU * u0), -2.0, 2.0)

    def shoot(fpp0, idx):
        return _shoot(fpp0, fp0[idx], f0[idx], eta_max, n)

    every = np.arange(fp0.shape[0])
    a = np.zeros(fp0.shape, np.float64)
    b = np.full(fp0.shape, 2.0)
    fa, fb = shoot(a, every), shoot(b, every)
    for _ in range(12):
        idx = np.nonzero(fa * fb > 0)[0]
        if idx.size == 0:
            break
        b[idx] *= 2.0
        fb[idx] = shoot(b[idx], idx)
    fallback = fa * fb > 0
    idx = np.nonzero(~fallback)[0]
    a, b, fa = a[idx], b[idx], fa[idx]
    for _ in range(60):                  # bisection
        mid = 0.5 * (a + b)
        fm = shoot(mid, idx)
        left = fa * fm <= 0
        b = np.where(left, mid, b)
        a = np.where(left, a, mid)
        fa = np.where(left, fa, fm)
    fpp0 = np.full(fp0.shape, 0.4696)    # fallback: standard Blasius value
    fpp0[idx] = 0.5 * (a + b)
    traj = _blasius_integrate(fpp0, fp0, f0, eta_max, n, traj=True)
    eta = np.linspace(0.0, eta_max, n + 1)
    return eta, traj[:, 0].T.copy(), traj[:, 1].T.copy()


def solve_blasius(U0: float, uh: float, uv: float,
                  eta_max: float = 10.0, n: int = 400):
    """One sample of ``solve_blasius_batch``. Returns (eta, f, fp)."""
    eta, f, fp = solve_blasius_batch(U0, uh, uv, eta_max, n)
    return eta, f[0], fp[0]


def velocity_field(U0, uh, uv, X, Y, blasius=None):
    """Evaluate (u_x, u_y) on grid arrays X, Y (same shape). `blasius` is
    the sample's (eta, f, fp) table from ``solve_blasius_batch`` (shot
    here when None)."""
    eta_grid, f_tab, fp_tab = (solve_blasius(U0, uh, uv) if blasius is None
                               else blasius)
    x_safe = np.maximum(X, 1e-3)
    eta = Y * np.sqrt(max(U0, 1e-8) / (2.0 * NU * x_safe))
    eta_c = np.clip(eta, 0.0, eta_grid[-1])
    fp = np.interp(eta_c, eta_grid, fp_tab)
    f = np.interp(eta_c, eta_grid, f_tab)
    ux = fp * U0
    uy = 0.5 * np.sqrt(NU * max(U0, 1e-8) / x_safe) * (eta_c * fp - f)
    return ux.astype(np.float32), uy.astype(np.float32)


# ---------------------------------------------------------------------------
# 2. Steady transport solve (torch, every sample at once)
# ---------------------------------------------------------------------------

def make_grid(nx: int = 96, ny: int = 48, lx: float = 2.0, ly: float = 1.0):
    x = np.linspace(0.0, lx, nx)
    y = np.linspace(0.0, ly, ny)
    X, Y = np.meshgrid(x, y, indexing="ij")
    return X.astype(np.float32), Y.astype(np.float32)


def source_fields(X, Y):
    q1 = np.where((X - 0.1) ** 2 + (Y - 0.1) ** 2 < 0.25, 0.1, 0.0)
    q2 = np.where((X - 0.1) ** 2 + (Y - 0.3) ** 2 < 0.25, 0.1, 0.0)
    return q1.astype(np.float32), q2.astype(np.float32)


def _apply_bc(c):
    """In place, in the reference's order (it fixes the corners)."""
    c[:, 0, :] = 0.0                     # inflow
    c[:, -1, :] = c[:, -2, :]            # outflow
    c[:, :, 0] = c[:, :, 1]              # terrain Neumann
    c[:, :, -1] = c[:, :, -2]            # top Neumann
    return c


@torch.no_grad()
def march(ux, uy, D, K12, K3, q1, q2, dx: float, dy: float,
          n_iter: int = 20000, tol: float = 1e-5):
    """Pseudo-time march the 3-species system to steady state, for S
    samples at once: `ux`, `uy` (S, nx, ny), `D`, `K12`, `K3` (S,), `q1`,
    `q2` (nx, ny), all float32 tensors on one device. Returns (c1, c2, c3)
    (S, nx, ny) and each sample's iteration count (S,) int32.

    Local time stepping (per-cell CFL limit), stopping on the PDE residual
    max |dc/dtau| < `tol` over all three species, or at `n_iter`. A sample
    takes a step while its own ``(it < n_iter) & (res > tol)`` holds and
    keeps its state after (the reference's ``vmap`` of a ``while_loop``),
    so its result does not depend on the other samples. The host reads
    whether any sample is active every ``CHECK_EVERY`` steps."""
    dev = ux.device
    f32 = dict(dtype=torch.float32, device=dev)
    # divisors as device tensors: a CUDA division by a host scalar is a
    # multiply by its reciprocal, which rounds differently
    dx_t, dy_t = torch.tensor(dx, **f32), torch.tensor(dy, **f32)
    dx2_t, dy2_t = torch.tensor(dx ** 2, **f32), torch.tensor(dy ** 2, **f32)
    ux = torch.nan_to_num(ux)
    uy = torch.nan_to_num(uy)
    D, K12, K3 = (v.reshape(-1, 1, 1) for v in (D, K12, K3))
    up_x, up_y = ux > 0, uy > 0

    def transport(c):
        """-u.grad c + D lap c: upwind advection, central diffusion (the
        four periodic neighbours are rolled once, exact copies)."""
        xm, xp = torch.roll(c, 1, 1), torch.roll(c, -1, 1)
        ym, yp = torch.roll(c, 1, 2), torch.roll(c, -1, 2)
        adv_x = torch.where(up_x, ux * ((c - xm) / dx_t),
                            ux * ((xp - c) / dx_t))
        adv_y = torch.where(up_y, uy * ((c - ym) / dy_t),
                            uy * ((yp - c) / dy_t))
        lap = (xp - 2 * c + xm) / dx2_t + (yp - 2 * c + ym) / dy2_t
        return -(adv_x + adv_y) + D * lap

    # per-cell stable pseudo-step; the reaction bound uses the source-scale
    # concentration cap
    base = (torch.abs(ux) / dx_t + torch.abs(uy) / dy_t
            + 2.0 * D * (1.0 / dx ** 2 + 1.0 / dy ** 2))
    cmax = 2.0
    # (a host scalar over a tensor is its reciprocal times the scalar)
    dt_loc = torch.tensor(0.7, **f32) / (base + K12 * cmax + K3 + 1e-3)

    S = ux.shape[0]
    c1 = torch.zeros(ux.shape, **f32)
    c2, c3 = torch.zeros_like(c1), torch.zeros_like(c1)
    it = torch.zeros(S, dtype=torch.int32, device=dev)
    res = torch.ones(S, **f32)
    tol_t = torch.tensor(tol, **f32)
    for i in range(n_iter):
        active = (it < n_iter) & (res > tol_t)
        if i % CHECK_EVERY == 0 and not bool(active.any()):
            break
        r = K12 * c1 * c2
        dc1 = transport(c1) - r + q1
        dc2 = transport(c2) - r + q2
        dc3 = transport(c3) + r - K3 * c3
        c1n = _apply_bc(torch.clamp(c1 + dt_loc * dc1, 0.0, cmax))
        c2n = _apply_bc(torch.clamp(c2 + dt_loc * dc2, 0.0, cmax))
        c3n = _apply_bc(torch.clamp(c3 + dt_loc * dc3, 0.0, cmax))
        resn = torch.maximum(
            (c1n - c1).abs().amax((1, 2)),
            torch.maximum((c2n - c2).abs().amax((1, 2)),
                          (c3n - c3).abs().amax((1, 2))))
        keep = active.view(-1, 1, 1)
        c1 = torch.where(keep, c1n, c1)
        c2 = torch.where(keep, c2n, c2)
        c3 = torch.where(keep, c3n, c3)
        res = torch.where(active, resn, res)
        it = it + active.to(torch.int32)
    return c1, c2, c3, it


def steady_transport(ux, uy, D, K12, K3, q1, q2, dx: float, dy: float,
                     n_iter: int = 20000, tol: float = 1e-5):
    """(c1, c2, c3) of ``march``: the reference's ``steady_transport``
    for a batch of samples, (S, nx, ny) each."""
    return march(ux, uy, D, K12, K3, q1, q2, dx, dy, n_iter, tol)[:3]


# ---------------------------------------------------------------------------
# 3. LHS sampling + dataset assembly
# ---------------------------------------------------------------------------

def latin_hypercube(n: int, dims: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = (rng.permutation(n)[:, None] if dims == 1 else
         np.stack([rng.permutation(n) for _ in range(dims)], axis=1))
    return (u + rng.uniform(size=(n, dims))) / n


def sample_params(n: int, seed: int = 0) -> np.ndarray:
    """(n, 6) array in physical units, LHS over the paper's ranges."""
    unit = latin_hypercube(n, len(PARAM_ORDER), seed)
    cols = []
    for j, name in enumerate(PARAM_ORDER):
        lo, hi = PARAM_RANGES[name]
        cols.append(lo + unit[:, j] * (hi - lo))
    return np.stack(cols, axis=1).astype(np.float32)


def probe_points(n_points: int = 2670, seed: int = 1,
                 lx: float = 2.0, ly: float = 1.0) -> np.ndarray:
    """Probe locations biased toward the source / ground (paper §4)."""
    rng = np.random.default_rng(seed)
    n_src = n_points // 2
    n_gnd = n_points - n_src
    px_s = 0.1 + rng.exponential(0.35, n_src)
    py_s = 0.1 + rng.exponential(0.18, n_src) * rng.choice([-1, 1], n_src)
    px_g = rng.uniform(0, lx, n_gnd)
    py_g = rng.exponential(0.15, n_gnd)
    px = np.clip(np.concatenate([px_s, px_g]), 0.0, lx)
    py = np.clip(np.abs(np.concatenate([py_s, py_g])), 0.0, ly)
    return np.stack([px, py], axis=1).astype(np.float32)


class Solve(NamedTuple):
    """What ``solve_dataset`` measured beside the dataset."""
    c3: np.ndarray               # (n, nx, ny) raw pollutant fields
    iters: np.ndarray            # (n,) march iterations per sample
    shoot_s: float               # host seconds: shooting + velocity fields
    march_s: float               # seconds of the march, synchronised


def solve_dataset(n_samples: int = 1000, nx: int = 96, ny: int = 48,
                  n_points: int = 2670, n_iter: int = 4000, seed: int = 0,
                  device="cuda"):
    """``generate_dataset``'s dict, and its `Solve` record."""
    dev = resolve_device(device)
    lx, ly = 2.0, 1.0
    X, Y = make_grid(nx, ny, lx, ly)
    q1, q2 = source_fields(X, Y)
    dx, dy = lx / (nx - 1), ly / (ny - 1)
    params = sample_params(n_samples, seed)
    probes = probe_points(n_points, seed + 1, lx, ly)
    # bilinear sample indices
    gx = np.clip(probes[:, 0] / dx, 0, nx - 1 - 1e-3)
    gy = np.clip(probes[:, 1] / dy, 0, ny - 1 - 1e-3)
    ix, iy = gx.astype(int), gy.astype(int)
    fx, fy = gx - ix, gy - iy

    t0 = time.perf_counter()
    eta, f_tab, fp_tab = solve_blasius_batch(params[:, 3], params[:, 4],
                                             params[:, 5])
    uxs, uys = [], []
    for i, (K12, K3, D, U0, uh, uv) in enumerate(params):
        ux, uy = velocity_field(U0, uh, uv, X, Y, (eta, f_tab[i], fp_tab[i]))
        uxs.append(ux)
        uys.append(uy)
    shoot_s = time.perf_counter() - t0

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    t0 = time.perf_counter()
    _, _, c3, iters = march(put(np.stack(uxs)), put(np.stack(uys)),
                            put(params[:, 2]), put(params[:, 0]),
                            put(params[:, 1]), put(q1), put(q2), dx, dy,
                            n_iter=n_iter)
    c3, iters = c3.cpu().numpy(), iters.cpu().numpy()
    march_s = time.perf_counter() - t0
    Yv = ((1 - fx) * (1 - fy) * c3[:, ix, iy]
          + fx * (1 - fy) * c3[:, np.minimum(ix + 1, nx - 1), iy]
          + (1 - fx) * fy * c3[:, ix, np.minimum(iy + 1, ny - 1)]
          + fx * fy * c3[:, np.minimum(ix + 1, nx - 1),
                         np.minimum(iy + 1, ny - 1)]).astype(np.float32)

    # normalize: params to [-1, 1]; outputs scaled to O(1) (paper §4)
    lo = np.array([PARAM_RANGES[k][0] for k in PARAM_ORDER], np.float32)
    hi = np.array([PARAM_RANGES[k][1] for k in PARAM_ORDER], np.float32)
    Xn = 2.0 * (params - lo) / (hi - lo) - 1.0
    scale = max(float(np.std(Yv)), 1e-8)
    Yn = (Yv - float(np.mean(Yv))) / scale
    data = {"X": Xn, "Y": Yn, "params_raw": params, "probes": probes,
            "y_mean": np.float32(np.mean(Yv)), "y_scale": np.float32(scale)}
    return data, Solve(c3, iters, shoot_s, march_s)


def generate_dataset(n_samples: int = 1000, nx: int = 96, ny: int = 48,
                     n_points: int = 2670, n_iter: int = 4000,
                     seed: int = 0, batch: int = 32, verbose: bool = False,
                     device="cuda") -> Dict[str, np.ndarray]:
    """Full paper dataset: X (n, 6) normalized params, Y (n, n_points)
    normalized c3 at probes. The shooting and the velocity fields run on
    the host; the march runs on `device` (a card unless the caller asks
    for ``"cpu"``), every sample at once. `batch` is the reference's
    chunk size; the result does not depend on it, and it is unused."""
    data, solve = solve_dataset(n_samples, nx, ny, n_points, n_iter, seed,
                                device)
    if verbose:
        it = solve.iters
        print(f"  {n_samples} samples: shooting {solve.shoot_s:.3f} s on "
              f"the host, march {solve.march_s:.3f} s on {device}; "
              f"iterations min {it.min()} median {np.median(it)} max "
              f"{it.max()}, {int((it >= n_iter).sum())} at the cap")
    return data


def train_test_split(data: Dict[str, np.ndarray], train_frac: float = 0.8,
                     seed: int = 2):
    n = data["X"].shape[0]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    k = int(n * train_frac)
    tr, te = perm[:k], perm[k:]
    return ((data["X"][tr], data["Y"][tr]), (data["X"][te], data["Y"][te]))
