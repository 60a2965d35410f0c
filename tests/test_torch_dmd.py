"""The port's Gram-form DMD algebra against the reference's, on the same
fp32 Grams. Only the coefficients ``c`` are compared, never eigenvectors
(defined up to sign/rotation). Tolerance: |c_port - c_ref| <= 2e-4 *
max(1, |c_ref|), the spread two LAPACK eigensolvers give after the
s-step matrix power on these Grams (the two packages' ``eigh`` round
differently)."""
import numpy as np
import pytest
import torch

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
    g = torch.tensor(_gram("random", np.random.default_rng(7)))
    with pytest.raises(NotImplementedError, match="eig"):
        tdmd.dmd_coefficients(g, s=5, mode="eig")
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
