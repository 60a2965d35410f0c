"""The port's Gram-form DMD algebra against the reference's, on the same
fp32 Grams. Only the coefficients ``c`` are compared, never eigenvectors
(defined up to sign/rotation). Tolerance: |c_port - c_ref| <= 2e-4 *
max(1, |c_ref|), the spread the two packages' matmuls leave after the
s-step matrix power on these Grams: of the two steps that decide the rank
mask, the affine shift's mean rounds as the reference's to the bit and
the eigenvalues of X^T X agree to fp32's resolution
(``test_rank_deciding_steps_round_as_the_reference``)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import dmd as jdmd
from repro_torch.core import dmd as tdmd

M = 8


def _gram(kind: str, rng) -> np.ndarray:
    n = 60
    w0 = rng.normal(size=n)
    t = np.arange(M)[:, None]
    if kind == "random":                 # noisy random walk
        S = w0 + np.cumsum(0.05 * rng.normal(size=(M, n)), axis=0)
    elif kind == "rank_deficient":       # a 2-D trajectory subspace
        basis = rng.normal(size=(2, n))
        coef = np.stack([np.cos(0.3 * t[:, 0]), np.sin(0.3 * t[:, 0])], 1)
        S = w0 + 0.1 * coef @ basis
    elif kind == "defective":            # pure drift: Jordan-block operator
        S = w0 + 0.01 * t * rng.normal(size=n)
    else:
        raise ValueError(kind)
    D = S - S[:1]
    return (D @ D.T).astype(np.float32)


CASES = [
    dict(s=10, tol=1e-4, anchor="first", affine=True, trust_region=2.0),
    dict(s=10, tol=1e-4, anchor="first", affine=True, trust_region=0.0),
    dict(s=10, tol=1e-4, anchor="first", affine=True, trust_region=2.0,
         ridge=0.05),
    dict(s=5, tol=1e-4, anchor="first", affine=False, trust_region=0.0,
         relax=0.7),
    dict(s=10, tol=1e-4, anchor="none", affine=True, trust_region=2.0),
    dict(s=10, tol=1e-4, anchor="mean", affine=True, trust_region=2.0),
    dict(s=10, tol=1e-4, anchor="first", affine=True, trust_region=2.0,
         energy=0.99, atol=1e-6),
]


def _coeffs(g: np.ndarray, **kw):
    cj, ij = jdmd.dmd_coefficients(jnp.asarray(g), **kw)
    ct, it = tdmd.dmd_coefficients(torch.tensor(g), **kw)
    return np.asarray(cj), ct.numpy(), ij, it


KINDS = ["random", "rank_deficient", "defective"]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("kind", KINDS)
def test_coefficients_match_reference(kind, case):
    rng = np.random.default_rng(100 * KINDS.index(kind) + case)
    g = np.stack([_gram(kind, rng) for _ in range(3)])    # batched systems
    kw = dict(CASES[case])
    if kind != "random":
        # exactly low-rank data: fp32 eigh leaves its zero eigenvalues at
        # ~1e-7 of the largest, a sigma ratio of ~3e-4. Below tol they are
        # masked and c is well defined; above it both packages fit noise
        # and agree on nothing, so mask it as the reference's tests do.
        kw["tol"] = 1e-3
    cj, ct, ij, it = _coeffs(g, **kw)
    assert ct.shape == cj.shape == (3, M)
    assert np.isfinite(ct).all()
    np.testing.assert_allclose(ct, cj, rtol=0,
                               atol=2e-4 * max(1.0, np.abs(cj).max()))
    np.testing.assert_array_equal(it["rank"].numpy(), np.asarray(ij["rank"]))
    for k in ("jump_scale", "jump_norm", "step_rms"):
        np.testing.assert_allclose(it[k].numpy(), np.asarray(ij[k]),
                                   rtol=1e-3, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("m", [3, 8, 14, 32])
def test_rank_deciding_steps_round_as_the_reference(m):
    """The two steps whose rounding decides the rank mask. The affine
    shift's mean equals the reference's bit for bit (XLA's reduce: an
    in-order fp32 sum times the fp32 reciprocal). The eigenvalues of X^T X
    (LAPACK on the host: ``torch.linalg.eigh``'s here, the reference's is
    scipy's ``syevd``) agree with the reference's to fp32's resolution,
    k * eps * lambda_max for k x k matrices (LAPACK's backward error
    bound; measured up to 5.7 eps * lambda_max), on symmetric fp32 Grams
    across six decades of scale."""
    rng = np.random.default_rng(m)
    a = rng.normal(size=(6, m, 40)) * 10.0 ** rng.uniform(-3, 3, (6, 1, 1))
    g = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
    g = (g + np.swapaxes(g, -1, -2)) / np.float32(2)      # exactly symmetric
    mean = jax.jit(lambda x: jnp.mean(
        jnp.diagonal(x, axis1=-2, axis2=-1), axis=-1))
    np.testing.assert_array_equal(
        tdmd._mean_in_order(torch.diagonal(torch.from_numpy(g), dim1=-2,
                                           dim2=-1)).numpy(),
        np.asarray(mean(g)))
    w, _ = tdmd._lag_eigh(torch.from_numpy(g))
    jw = np.asarray(jax.jit(jnp.linalg.eigh)(g)[0])
    res = m * np.finfo(np.float32).eps * np.abs(jw).max(axis=-1)
    assert (np.abs(w.numpy() - jw).max(axis=-1) <= res).all()


def test_ridge_zero_vs_positive():
    """ridge=0 keeps the exact pseudo-inverse; a huge ridge collapses the
    fitted dynamics and the jump onto the anchor, in both packages."""
    rng = np.random.default_rng(3)
    g = _gram("random", rng)
    base = dict(s=10, tol=1e-4, anchor="first", affine=True,
                trust_region=0.0)
    c0j, c0t, _, _ = _coeffs(g, **base)
    cbj, cbt, _, _ = _coeffs(g, ridge=1e6, **base)
    np.testing.assert_allclose(c0t, c0j, atol=2e-4 * max(1, abs(c0j).max()))
    np.testing.assert_allclose(cbt, cbj, atol=1e-5)
    anchor = np.zeros(M, np.float32)
    anchor[0] = 1.0
    np.testing.assert_allclose(cbt, anchor, atol=1e-3)
    assert np.abs(c0t - anchor).max() > 0.1


def test_non_finite_gram_keeps_last_snapshot():
    g = _gram("random", np.random.default_rng(4))
    g[2, 3] = np.nan
    for tr in (0.0, 2.0):
        cj, ct, _, _ = _coeffs(g, s=10, tol=1e-4, anchor="first",
                               affine=True, trust_region=tr)
        e_last = np.eye(M, dtype=np.float32)[-1]
        np.testing.assert_array_equal(ct, e_last)
        np.testing.assert_array_equal(ct, cj)


def test_gram_helpers_match_reference():
    rng = np.random.default_rng(5)
    S = rng.normal(size=(M, 4, 9)).astype(np.float32)
    p = rng.normal(size=(4, 9)).astype(np.float32)
    for anchor in ("none", "first", "mean"):
        np.testing.assert_allclose(
            tdmd.gram_matrix(torch.tensor(S), anchor).numpy(),
            np.asarray(jdmd.gram_matrix(jnp.asarray(S), anchor)),
            rtol=1e-5, atol=1e-5)
    for anchor in ("none", "first"):
        np.testing.assert_allclose(
            tdmd.gram_row_matrix(torch.tensor(S), torch.tensor(p),
                                 anchor).numpy(),
            np.asarray(jdmd.gram_row_matrix(jnp.asarray(S), jnp.asarray(p),
                                            anchor)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        tdmd.gram_row_matrix(torch.tensor(S), torch.tensor(p), "mean")
    g = rng.normal(size=(2, M, M)).astype(np.float32)
    row = rng.normal(size=(2, M)).astype(np.float32)
    want = np.asarray(jdmd.set_gram_row(jnp.asarray(g), jnp.asarray(row), 3))
    got = tdmd.set_gram_row(torch.tensor(g), torch.tensor(row), 3).numpy()
    np.testing.assert_array_equal(got, want)


def test_matrix_power_and_masks_match_reference():
    rng = np.random.default_rng(6)
    a = (0.3 * rng.normal(size=(2, 5, 5))).astype(np.float32)
    for s in (1, 2, 5, 13, 55):
        np.testing.assert_allclose(
            tdmd._matrix_power(torch.tensor(a), s).numpy(),
            np.asarray(jdmd._matrix_power(jnp.asarray(a), s)),
            rtol=1e-4, atol=1e-6)
    ev = np.sort(np.abs(rng.normal(size=(3, 7))), axis=-1).astype(np.float32)
    ev[0, :3] = [0.0, 1e-12, -1e-9]
    for kw in (dict(tol=1e-4), dict(tol=1e-4, energy=0.9),
               dict(tol=1e-4, atol=0.5)):
        st, it, mt = tdmd._masked_inv_sigma(torch.tensor(ev), **kw)
        sj, ij, mj = jdmd._masked_inv_sigma(jnp.asarray(ev), **kw)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=1e-6)
        r_t = tdmd._ridge_inv_sigma(st, mt, 0.1).numpy()
        r_j = jdmd._ridge_inv_sigma(sj, mj, 0.1)
        np.testing.assert_allclose(r_t, np.asarray(r_j), rtol=1e-6)


def test_unported_modes_raise():
    """Both modes of the reference run (eig mode gives the reference's c);
    an unknown mode and m < 3 raise ValueError, as in the reference."""
    g = torch.tensor(_gram("random", np.random.default_rng(7)))
    ct, _ = tdmd.dmd_coefficients(g, s=5, mode="eig", tol=1e-4)
    cj, _ = jdmd.dmd_coefficients(jnp.asarray(g.numpy()), s=5, mode="eig",
                                  tol=1e-4)
    assert torch.isfinite(ct).all()
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                               atol=2e-4 * max(1.0, np.abs(cj).max()))
    with pytest.raises(ValueError, match="unknown DMD mode"):
        tdmd.dmd_coefficients(g, s=5, mode="schur")
    with pytest.raises(ValueError, match="m >= 3"):
        tdmd.dmd_coefficients(g[:2, :2], s=5)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("s_dyn,ridge_dyn", [(1, None), (7, None), (10, None),
                                             (25, None), (4, 0.05),
                                             (None, 0.0), (None, 0.08)])
def test_dynamic_horizon_and_ridge_match_reference(kind, s_dyn, ridge_dyn):
    """The controller's dynamic horizon (clamped into [1, s]) and
    meta-tuned ridge, as tensors, against the reference's traced ones;
    same tolerance as the static cases."""
    g = _gram(kind, np.random.default_rng(11))
    # exactly low-rank data masks its fp32 noise floor at tol 1e-3, as in
    # test_coefficients_match_reference
    kw = dict(s=10, tol=1e-4 if kind == "random" else 1e-3, anchor="first",
              affine=True, trust_region=2.0)
    jkw, tkw = dict(kw), dict(kw)
    if s_dyn is not None:
        jkw["s_dyn"] = jnp.asarray(s_dyn, jnp.int32)
        tkw["s_dyn"] = torch.tensor(s_dyn, dtype=torch.int32)
    if ridge_dyn is not None:
        jkw["ridge_dyn"] = jnp.asarray(ridge_dyn, jnp.float32)
        tkw["ridge_dyn"] = torch.tensor(ridge_dyn)
    cj, _ = jdmd.dmd_coefficients(jnp.asarray(g), **jkw)
    ct, _ = tdmd.dmd_coefficients(torch.tensor(g), **tkw)
    cj = np.asarray(cj)
    np.testing.assert_allclose(ct.numpy(), cj,
                               atol=2e-4 * max(1.0, np.abs(cj).max()))


def test_traced_matrix_power_matches_static():
    """Masked binary exponentiation over the cap's bits equals the static
    chain exactly for every s in [1, cap], per system too."""
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.normal(size=(3, 5, 5)).astype(np.float32) * 0.5)
    for s in range(1, 12):
        got = tdmd._matrix_power_traced(a, torch.tensor(s), 11)
        np.testing.assert_allclose(got.numpy(),
                                   tdmd._matrix_power(a, s).numpy(),
                                   rtol=1e-5, atol=1e-6)
    per = tdmd._matrix_power_traced(a, torch.tensor([1, 4, 9]), 11)
    for i, s in enumerate((1, 4, 9)):
        np.testing.assert_allclose(per[i].numpy(),
                                   tdmd._matrix_power(a[i], s).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_coefficients_differentiable_in_relax_and_ridge():
    """Meta-tuning backpropagates through the solve: the gradient of a
    scalar of c in relax and ridge_dyn matches JAX's (same Gram)."""
    import jax
    g = _gram("random", np.random.default_rng(5))
    w = np.random.default_rng(6).normal(size=M).astype(np.float32)

    def jf(r, k):
        c, _ = jdmd.dmd_coefficients(jnp.asarray(g), s=10, tol=1e-4,
                                     anchor="first", affine=True,
                                     trust_region=2.0, relax=r,
                                     ridge_dyn=k)
        return jnp.sum(c * jnp.asarray(w))
    gj = jax.grad(jf, argnums=(0, 1))(jnp.float32(0.8), jnp.float32(0.03))
    r = torch.tensor(0.8, requires_grad=True)
    k = torch.tensor(0.03, requires_grad=True)
    c, _ = tdmd.dmd_coefficients(torch.tensor(g), s=10, tol=1e-4,
                                 anchor="first", affine=True,
                                 trust_region=2.0, relax=r, ridge_dyn=k)
    gr, gk = torch.autograd.grad((c * torch.tensor(w)).sum(), (r, k))
    for got, want in ((gr, gj[0]), (gk, gj[1])):
        want = float(want)
        assert abs(float(got) - want) <= 2e-3 * max(1.0, abs(want))


# -- eig mode -----------------------------------------------------------------
# The reference's classic-DMD power (``_eig_power``: host eig, |lambda|
# clamp, the defective-operator guard) against the port's. Tolerances, as
# |c_port - c_ref| <= tol * max(1, |c_ref|): 2e-4 on the random and
# rank-deficient Grams (measured <= 1.5e-5), 5e-4 on the defective
# (Jordan-block) ones (measured 2.3e-4): there eig splits the double
# eigenvalue 1 into 1 +- delta with huge opposing amplitudes, and the
# reference against itself, with its Gram moved by a relative 1e-7, moves
# c by 1.5e-4. On the SAME operator the two eig powers agree to 1e-5 of
# their scale (measured 2.3e-6 at s = 55).
EIG_TOL = {"random": 2e-4, "rank_deficient": 2e-4, "defective": 5e-4}


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("kind", KINDS)
def test_eig_coefficients_match_reference(kind, case, clamp, dynamic):
    rng = np.random.default_rng(100 * KINDS.index(kind) + case)
    g = np.stack([_gram(kind, rng) for _ in range(3)])
    kw = dict(CASES[case], mode="eig", clamp_eigs=clamp)
    if kind != "random":
        kw["tol"] = 1e-3             # above the fp32 noise floor, as above
    jkw, tkw = dict(kw), dict(kw)
    if dynamic:                      # the controller's horizon, capped by s
        jkw["s_dyn"] = jnp.asarray(kw["s"] - 3, jnp.int32)
        tkw["s_dyn"] = torch.tensor(kw["s"] - 3, dtype=torch.int32)
    cj, ij = jdmd.dmd_coefficients(jnp.asarray(g), **jkw)
    ct, it = tdmd.dmd_coefficients(torch.tensor(g), **tkw)
    cj = np.asarray(cj)
    assert ct.shape == cj.shape == (3, M) and torch.isfinite(ct).all()
    np.testing.assert_allclose(ct.numpy(), cj, rtol=0, atol=EIG_TOL[kind]
                               * max(1.0, np.abs(cj).max()))
    np.testing.assert_array_equal(it["rank"].numpy(), np.asarray(ij["rank"]))


def _operators():
    rng = np.random.default_rng(12)
    a = (0.4 * rng.normal(size=(5, 6, 6))).astype(np.float32)
    a[0] = np.eye(6) + np.diag(np.full(5, 0.1), 1)           # Jordan block
    a[1] = np.diag([1.1, 0.9, 0.8, 0.0, 0.0, 0.5])           # growth, zeros
    a[2] = np.diag([7.0, 0.5, 0.3, 0.2, 0.1, 0.05])          # 7^55 overflows
    return a


@pytest.mark.parametrize("s", [1, 5, 55])
@pytest.mark.parametrize("clamp", [False, True])
def test_eig_power_matches_reference_on_the_same_operator(s, clamp):
    """``Atilde^s`` of the two packages on identical operators: the
    reconstruction, the clamp, the zero-eigenvalue guard and the matpow
    fallback, static and dynamic s."""
    a = _operators()
    for sj, st in ((s, s), (jnp.asarray(s, jnp.int32),
                            torch.tensor(s, dtype=torch.int32))):
        want = np.asarray(jdmd._eig_power(jnp.asarray(a), sj, clamp,
                                          s_max=55))
        got = tdmd._eig_power(torch.tensor(a), st, clamp, 55).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        fin = np.isfinite(want)
        scale = np.maximum(np.abs(np.where(fin, want, 0)).max(
            axis=(1, 2), keepdims=True), 1.0)
        np.testing.assert_allclose(np.where(fin, got, 0) / scale,
                                   np.where(fin, want, 0) / scale, atol=1e-5)


def test_eig_host_step_counts_and_guards():
    """One host round trip per call, whatever the batch; the guard's
    fallbacks are counted (the Jordan block falls back to matpow at s =
    55); a non-finite operator falls back instead of raising."""
    a = torch.tensor(_operators())
    tdmd.reset_eig_stats()
    tdmd._eig_power(a, 55, False, 55)
    st = tdmd.eig_stats()
    assert (st["calls"], st["systems"]) == (1, 5) and st["fallbacks"] >= 1
    bad = a.clone()
    bad[3, 0, 0] = float("nan")
    out = tdmd._eig_power(bad, 5, False, 5)
    assert not torch.isfinite(out[3]).all()
    np.testing.assert_array_equal(
        out[4].numpy(), tdmd._eig_power(a[4:], 5, False, 5)[0].numpy())
    assert tdmd.eig_stats()["calls"] == 3


def _linear_traj(n=64, m=10, rank=4, seed=0, spectrum=None):
    """tests/test_dmd.py::make_linear_traj."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    eigs = np.zeros(n)
    eigs[:rank] = spectrum if spectrum is not None else \
        np.linspace(0.95, 0.7, rank)
    a = (q * eigs) @ q.T
    w = rng.normal(size=n)
    snaps = []
    for _ in range(m):
        w = a @ w
        snaps.append(w.copy())
    return np.stack(snaps)


def test_eigenvalue_recovery_and_spectra_match_reference():
    """tests/test_dmd.py:72 restated: the 4 magnitudes of a rank-4 linear
    trajectory recovered to 1e-3; and ``dmd_eigenvalues(_from_gram)``
    (float64 on the host; real or complex as numpy's ``eigvals`` returns
    them) equal to the reference's to 1e-10."""
    spectrum = np.array([0.95, 0.9, 0.85, 0.8])
    S = _linear_traj(rank=4, spectrum=spectrum, m=12)
    ev = tdmd.dmd_eigenvalues(torch.tensor(S), tol=1e-8)
    np.testing.assert_allclose(sorted(np.abs(ev), reverse=True)[:4],
                               sorted(spectrum, reverse=True), atol=1e-3)
    for anchor in ("none", "first", "mean"):
        want = jdmd.dmd_eigenvalues(jnp.asarray(S, jnp.float32), tol=1e-8,
                                    anchor=anchor)
        got = tdmd.dmd_eigenvalues(torch.tensor(S, dtype=torch.float32),
                                   tol=1e-8, anchor=anchor)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_allclose(np.sort_complex(got),
                                   np.sort_complex(want), atol=1e-10)
    g = _gram("random", np.random.default_rng(9))
    np.testing.assert_allclose(
        np.sort_complex(tdmd.dmd_eigenvalues_from_gram(torch.tensor(g),
                                                       tol=1e-4)),
        np.sort_complex(jdmd.dmd_eigenvalues_from_gram(g, tol=1e-4)),
        atol=1e-10)
    assert tdmd.dmd_eigenvalues_from_gram(np.zeros((M, M))).size == 0


def test_eig_clamp_on_defective_jordan_matches_matpow():
    """tests/test_dmd.py:407 restated: a drift trajectory's Jordan-block
    operator; eig with the clamp agrees with matpow and both with the
    exact drift, and the port's eig jump with the reference's (5e-3 of
    the scale, the pin's own bound)."""
    rng = np.random.default_rng(0)
    w0, v = rng.normal(size=32), rng.normal(size=32) * 0.1
    S = np.stack([w0 + t * v for t in range(8)]).astype(np.float32)
    for s in (5, 20, 60):
        truth = S[-1] + s * v
        scale = max(np.abs(truth).max(), 1.0)
        w_mp, _ = tdmd.dmd_extrapolate(torch.tensor(S), s=s, tol=1e-4,
                                       mode="matpow")
        w_eig, _ = tdmd.dmd_extrapolate(torch.tensor(S), s=s, tol=1e-4,
                                        mode="eig", clamp_eigs=True)
        w_ref, _ = jdmd.dmd_extrapolate(jnp.asarray(S), s=s, tol=1e-4,
                                        mode="eig", clamp_eigs=True)
        assert np.abs(w_mp.numpy() - truth).max() / scale < 1e-3, s
        assert np.abs(w_eig.numpy() - truth).max() / scale < 5e-3, s
        assert np.abs(w_eig.numpy() - w_mp.numpy()).max() / scale < 5e-3
        assert np.abs(w_eig.numpy() - np.asarray(w_ref)).max() / scale \
            < 5e-3, s


def test_eig_clamp_still_stabilizes_genuine_growth():
    """tests/test_dmd.py:435 restated: a genuine |lambda| = 1.1 mode
    explodes unclamped and stays bounded clamped, in both packages."""
    S = _linear_traj(rank=3, spectrum=np.array([1.1, 0.9, 0.8]), m=10)
    for lib, arr in ((tdmd, torch.tensor(S, dtype=torch.float32)),
                     (jdmd, jnp.asarray(S, jnp.float32))):
        w_c, _ = lib.dmd_extrapolate(arr, s=20, tol=1e-5, mode="eig",
                                     clamp_eigs=True)
        w_u, _ = lib.dmd_extrapolate(arr, s=20, tol=1e-5, mode="eig",
                                     clamp_eigs=False)
        assert np.linalg.norm(np.asarray(w_u)) > 3 * np.linalg.norm(
            np.asarray(w_c))


def test_eig_clamp_survives_fp32_overflow_of_unclamped_power():
    """tests/test_dmd.py:449 restated: 7^60 overflows fp32; the clamped
    eig jump stays finite, bounded and moving, as the reference's, and
    equal to it to 1e-4 of the trajectory's scale."""
    S = _linear_traj(rank=2, spectrum=np.array([7.0, 0.5]), m=10, seed=4)
    S = (S / np.abs(S).max()).astype(np.float32)
    w_c, _ = tdmd.dmd_extrapolate(torch.tensor(S), s=60, tol=1e-5,
                                  mode="eig", clamp_eigs=True)
    w_j, _ = jdmd.dmd_extrapolate(jnp.asarray(S), s=60, tol=1e-5,
                                  mode="eig", clamp_eigs=True)
    assert torch.isfinite(w_c).all()
    assert np.linalg.norm(w_c.numpy()) < 10 * np.linalg.norm(S[-1])
    assert np.linalg.norm(w_c.numpy() - S[-1]) > 0
    np.testing.assert_allclose(w_c.numpy(), np.asarray(w_j), rtol=0,
                               atol=1e-4 * max(1.0, np.abs(S).max()))
