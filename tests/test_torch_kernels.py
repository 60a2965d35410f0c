"""The port's arena kernel twins against the reference's Pallas kernels
(interpret mode) and reference twins, on the reference test layout:
systems of 7, 130, 333 and 128 lanes in 128-lane blocks.

Tolerances: random fp32 data rtol 1e-6 / atol 1e-5 (summation order only,
the bound the reference's own kernel tests use); integer-valued data and
bf16-exact values must match exactly. The wrappers route CPU tensors to
the twins, so they are held to the same bounds, and their input checks
are exercised here too."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import arena as jka
from repro_torch.kernels import arena as tka

SIZES = [7, 130, 333, 128]
BLOCK_N = 128
M = 5


def _layout(rng, integer=False):
    segs = [-(-s // BLOCK_N) * BLOCK_N for s in SIZES]
    n = sum(segs)
    x = np.zeros((M, n), np.float32)
    q = np.zeros((n,), np.float32)
    block_sys, lane = [], 0
    for i, (s, p) in enumerate(zip(SIZES, segs)):
        draw = ((lambda sz: rng.integers(-8, 9, size=sz)) if integer
                else (lambda sz: rng.normal(size=sz)))
        x[:, lane:lane + s] = draw((M, s))
        q[lane:lane + s] = draw(s)
        block_sys += [i] * (p // BLOCK_N)
        lane += p
    xb = np.ascontiguousarray(
        x.reshape(M, n // BLOCK_N, BLOCK_N).transpose(1, 0, 2))
    qb = q.reshape(n // BLOCK_N, BLOCK_N)
    c = rng.normal(size=(len(SIZES), M)).astype(np.float32)
    if integer:
        c = np.round(c * 4)
    return xb, qb, np.asarray(block_sys, np.int32), c


def _jax_all(xb, qb, bs, c, anchor_first, dtype=jnp.float32):
    x, q = jnp.asarray(xb, dtype), jnp.asarray(qb, dtype)
    n_sys = len(SIZES)
    return {
        "row_pallas": jka.gram_row_pallas(x, q, bs, n_sys,
                                          anchor_first=anchor_first,
                                          block_n=BLOCK_N, interpret=True),
        "row_ref": jka.gram_row_ref(x, q, bs, n_sys,
                                    anchor_first=anchor_first,
                                    block_n=BLOCK_N),
        "gram_pallas": jka.gram_pallas(x, bs, n_sys,
                                       anchor_first=anchor_first,
                                       block_n=BLOCK_N, interpret=True),
        "gram_ref": jka.gram_ref(x, bs, n_sys, anchor_first=anchor_first,
                                 block_n=BLOCK_N),
        "comb_pallas": jka.combine_pallas(x, jnp.asarray(c), bs,
                                          block_n=BLOCK_N, interpret=True),
        "comb_ref": jka.combine_ref(x, jnp.asarray(c), bs, block_n=BLOCK_N),
    }


def _torch_all(xb, qb, bs, c, anchor_first, dtype=torch.float32):
    x = torch.tensor(xb).to(dtype)
    q = torch.tensor(qb).to(dtype)
    seg = tka.Segments.from_block_sys(bs, len(SIZES), "cpu")
    ct = torch.tensor(c)
    return {
        "row_twin": tka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                     anchor_first=anchor_first),
        "row_wrap": tka.gram_row(x, q, seg, anchor_first=anchor_first),
        "gram_twin": tka.gram_ref(x, seg.block_sys, seg.n_sys,
                                  anchor_first=anchor_first),
        "gram_wrap": tka.gram(x, seg, anchor_first=anchor_first),
        "comb_twin": tka.combine_ref(x, ct, seg.block_sys),
        "comb_wrap": tka.combine(x, ct, seg),
    }


def _check(j, t, exact):
    pairs = [("row_twin", "row_pallas"), ("row_twin", "row_ref"),
             ("row_wrap", "row_ref"), ("gram_twin", "gram_pallas"),
             ("gram_twin", "gram_ref"), ("gram_wrap", "gram_ref"),
             ("comb_twin", "comb_pallas"), ("comb_twin", "comb_ref"),
             ("comb_wrap", "comb_ref")]
    for tk, jk in pairs:
        got, want = t[tk].numpy(), np.asarray(j[jk])
        assert got.dtype == np.float32 and got.shape == want.shape, tk
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"{tk}/{jk}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5,
                                       err_msg=f"{tk}/{jk}")


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("anchor_first", [False, True])
def test_twins_match_reference_kernels(anchor_first, integer):
    xb, qb, bs, c = _layout(np.random.default_rng(1 + integer), integer)
    _check(_jax_all(xb, qb, bs, c, anchor_first),
           _torch_all(xb, qb, bs, c, anchor_first), exact=integer)


def test_twins_bf16_buffers():
    """bf16 storage, fp32 contraction: values exactly representable in bf16
    go through both packages; integer values keep every sum exact."""
    xb, qb, bs, c = _layout(np.random.default_rng(4), integer=True)
    _check(_jax_all(xb, qb, bs, c, True, jnp.bfloat16),
           _torch_all(xb, qb, bs, c, True, torch.bfloat16), exact=True)
    xb, qb, bs, c = _layout(np.random.default_rng(5))
    xb = np.asarray(jnp.asarray(xb, jnp.bfloat16).astype(jnp.float32))
    qb = np.asarray(jnp.asarray(qb, jnp.bfloat16).astype(jnp.float32))
    _check(_jax_all(xb, qb, bs, c, True, jnp.bfloat16),
           _torch_all(xb, qb, bs, c, True, torch.bfloat16), exact=False)


@pytest.mark.parametrize("integer", [False, True])
def test_mean_anchor_gram(integer):
    xb, _, bs, _ = _layout(np.random.default_rng(6), integer)
    want = jka.gram_pallas(jnp.asarray(xb), bs, len(SIZES), anchor_mean=True,
                           block_n=BLOCK_N, interpret=True)
    want_ref = jka.gram_ref(jnp.asarray(xb), bs, len(SIZES),
                            anchor_mean=True, block_n=BLOCK_N)
    seg = tka.Segments.from_block_sys(bs, len(SIZES), "cpu")
    got = tka.gram(torch.tensor(xb), seg, anchor_mean=True).numpy()
    # the mean of integers is not an integer: summation order shows, so
    # even the integer case gets the fp32 bound
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(want_ref), rtol=1e-6,
                               atol=1e-5)


def test_segments_table():
    seg = tka.Segments.from_block_sys([0, 0, 1, 3, 3, 3], 4, "cpu")
    assert seg.sys_off.tolist() == [0, 2, 3, 3, 6]
    assert seg.block_sys.dtype == torch.int32
    with pytest.raises(ValueError, match="sorted"):
        tka.Segments.from_block_sys([1, 0], 2, "cpu")
    with pytest.raises(ValueError, match="outside"):
        tka.Segments.from_block_sys([0, 2], 2, "cpu")


def test_wrappers_reject_bad_inputs():
    seg = tka.Segments.from_block_sys([0, 0, 1], 2, "cpu")
    launches = dict(tka.LAUNCHES)
    x = torch.zeros((3, 4, 128))
    q = torch.zeros((3, 128))
    c = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="float32/bfloat16"):
        tka.gram(x.double(), seg)
    with pytest.raises(ValueError, match="m <= 32"):
        tka.gram(torch.zeros((3, 33, 128)), seg)
    with pytest.raises(ValueError, match="contiguous"):
        tka.gram(x.transpose(0, 1).contiguous().transpose(0, 1), seg)
    with pytest.raises(ValueError, match="query"):
        tka.gram_row(x, q.T.contiguous().T, seg)
    with pytest.raises(ValueError, match="query"):
        tka.gram_row(x, q.to(torch.bfloat16), seg)
    with pytest.raises(ValueError, match="does not fit"):
        tka.gram(torch.zeros((4, 4, 128)), seg)
    with pytest.raises(ValueError, match="coefficients"):
        tka.combine(x, c.double(), seg)
    with pytest.raises(ValueError, match="exclusive"):
        tka.gram(x, seg, anchor_first=True, anchor_mean=True)
    # a slot of the ring buffer is a valid (row-strided) query
    out = tka.gram_row(x, x[:, 2, :], seg, anchor_first=True)
    assert out.shape == (2, 4)
    # the CPU route launches nothing
    assert tka.LAUNCHES == launches
