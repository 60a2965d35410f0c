"""The port's flat kernel twins (K4 gram_row, K5 combine, K6 gram) against
the reference's Pallas kernels run in interpret mode, and the per-leaf
entry points of ``kernels/ops.py`` against the reference's.

Inputs are numpy-seeded. bf16 inputs are drawn as bf16-representable
values, so both packages see the same numbers. Tolerances: random data
|diff| <= 1e-5 * max(1, max|reference|) (fp32 summation order over up to
5000 lanes; the two packages sum in different orders); integer-valued data
must match exactly (every fp32 sum is exact in any order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels.combine import combine_pallas
from repro.kernels.gram import gram_pallas
from repro.kernels.gram_row import gram_row_pallas
from repro_torch.kernels import combine as tcombine
from repro_torch.kernels import device as tdevice
from repro_torch.kernels import gram as tgram
from repro_torch.kernels import gram_row as tgram_row
from repro_torch.kernels import ops as tops


def _close(got: torch.Tensor, want, exact=False, what=""):
    got = got.numpy()
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape, what
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=what)


def _draw(rng, shape, dtype, integer=False):
    """numpy fp32 values exactly representable in `dtype`, the JAX array
    and the torch tensor holding them."""
    v = (rng.integers(-8, 9, size=shape) if integer
         else rng.normal(size=shape)).astype(np.float32)
    j = jnp.asarray(v, dtype)
    v = np.asarray(j.astype(jnp.float32))
    t = torch.tensor(v).to(torch.bfloat16 if dtype == jnp.bfloat16
                           else torch.float32)
    return v, j, t


@pytest.mark.parametrize("n", [40, 128, 333, 5000])
@pytest.mark.parametrize("m", [1, 3, 8, 14, 32])
def test_twins_match_pallas_kernels(m, n):
    rng = np.random.default_rng(m * 10007 + n)
    block_n = jops.lane_block(2048, n)
    for dtype in (jnp.float32, jnp.bfloat16):
        _, jx, tx = _draw(rng, (m, n), dtype)
        _, jq, tq = _draw(rng, (n,), dtype)
        c = rng.normal(size=m).astype(np.float32)
        x3, q2 = tx.reshape(m, 1, n), tq.reshape(1, n)
        what = f"m={m} n={n} {dtype.__name__}"
        for anchor_first in (False, True):
            _close(tgram_row.gram_row_ref(x3, q2, anchor_first=anchor_first)[0],
                   gram_row_pallas(jx, jq, anchor_first=anchor_first,
                                   block_n=block_n, interpret=True),
                   what=f"gram_row {what} anchor={anchor_first}")
            _close(tgram.gram_ref(x3, anchor_first=anchor_first)[0],
                   gram_pallas(jx, anchor_first=anchor_first,
                               block_n=block_n, interpret=True),
                   what=f"gram {what} anchor={anchor_first}")
        _close(tcombine.combine_ref(x3, torch.tensor(c).reshape(1, m))[0],
               combine_pallas(jx, jnp.asarray(c), block_n=block_n,
                              interpret=True),
               what=f"combine {what}")


@pytest.mark.parametrize("anchor_first", [False, True])
def test_twins_exact_on_integer_data(anchor_first):
    rng = np.random.default_rng(5)
    m, n = 14, 333
    _, jx, tx = _draw(rng, (m, n), jnp.float32, integer=True)
    c = rng.integers(-4, 5, size=m).astype(np.float32)
    x3 = tx.reshape(m, 1, n)
    _close(tgram_row.gram_row_ref(x3, x3[m - 1], anchor_first=anchor_first)[0],
           gram_row_pallas(jx, jx[m - 1], anchor_first=anchor_first,
                           block_n=384, interpret=True), exact=True)
    _close(tgram.gram_ref(x3, anchor_first=anchor_first)[0],
           gram_pallas(jx, anchor_first=anchor_first, block_n=384,
                       interpret=True), exact=True)
    _close(tcombine.combine_ref(x3, torch.tensor(c).reshape(1, m))[0],
           combine_pallas(jx, jnp.asarray(c), block_n=384, interpret=True),
           exact=True)
    # slot 0 just written: the anchored row is exactly zero
    row0 = tgram_row.gram_row(x3, x3[0], anchor_first=True)
    assert torch.equal(row0, torch.zeros(1, m))


@pytest.mark.parametrize("stack", [(), (4,), (2, 3)])
def test_ops_entry_points_match_reference(stack):
    """ops.gram_row / gram / combine on (m, stack..., rest...) buffers: the
    stacked forms against the reference's per-system oracles (the
    ``kernels/sharded.py`` passes without a mesh reduce to these), the
    unstacked ones against ``repro.kernels.ops``."""
    rng = np.random.default_rng(len(stack))
    m, rest = 6, (5, 7)
    shape = (m,) + stack + rest
    k = len(stack)
    v, jx, tx = _draw(rng, shape, jnp.float32)
    c = rng.normal(size=stack + (m,)).astype(np.float32)
    q = tx[2]
    row = tops.gram_row(tx, q, anchor_first=True, stack_dims=k)
    g = tops.gram(tx, anchor_first=True, stack_dims=k)
    w = tops.combine(tx, torch.tensor(c), stack_dims=k)
    assert row.shape == stack + (m,) and g.shape == stack + (m, m)
    assert w.shape == stack + rest
    n_sys = int(np.prod(stack, dtype=np.int64))
    xs = np.moveaxis(v, 0, k).reshape((n_sys, m) + rest)
    cs = c.reshape(n_sys, m)
    for i in range(n_sys):
        idx = np.unravel_index(i, stack) if stack else ()
        xi = jnp.asarray(xs[i])
        _close(row[idx], jops.gram_row(xi, xi[2], anchor_first=True))
        _close(g[idx], jops.gram(xi, anchor_first=True))
        _close(w[idx], jops.combine(xi, jnp.asarray(cs[i])))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        tgram.gram(x.double())
    with pytest.raises(ValueError, match="m <= 32"):
        tgram.gram(torch.zeros(33, 1, 8))
    with pytest.raises(ValueError, match="unit stride"):
        tgram.gram(x.transpose(1, 2))
    with pytest.raises(ValueError, match="query"):
        tgram_row.gram_row(x, torch.zeros(2, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="coefficients"):
        tcombine.combine(x, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="contiguous"):
        tops.gram(torch.zeros(8, 4).T)
    with pytest.raises(ValueError, match="devices"):
        tcombine.combine(x, torch.zeros(2, 4, device="meta"))


def test_cpu_tensors_take_the_twins_and_count_no_launch():
    before = {**tgram_row.LAUNCHES, **tgram.LAUNCHES, **tcombine.LAUNCHES}
    x = torch.randn(5, 3, 11, generator=torch.Generator().manual_seed(0))
    c = torch.randn(3, 5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(tgram_row.gram_row(x, x[4], anchor_first=True),
                       tgram_row.gram_row_ref(x, x[4], anchor_first=True))
    assert torch.equal(tgram.gram(x), tgram.gram_ref(x))
    assert torch.equal(tcombine.combine(x, c), tcombine.combine_ref(x, c))
    assert {**tgram_row.LAUNCHES, **tgram.LAUNCHES,
            **tcombine.LAUNCHES} == before
    assert set(before) == {"flat_gram_row", "flat_gram", "flat_combine"}


def _view(m, n_sys, n, dtype=torch.float32, pad=0, offset=0):
    """An (m, S, n) view into one allocation: `pad` more lanes per system
    (the system stride is n + pad) and `offset` elements in."""
    flat = torch.zeros(offset + m * n_sys * (n + pad), dtype=dtype)
    return flat[offset:].view(m, n_sys, n + pad)[:, :, :n]


# (m, S, n, dtype, pad, offset) -> 16-byte loads? 4 fp32 / 8 bf16 lanes per
# load need every row and system to start 16-byte aligned and n whole units
@pytest.mark.parametrize("m,n_sys,n,dtype,pad,offset,want", [
    (14, 1, 2670000, torch.float32, 0, 0, True),    # /l3/w
    (14, 1, 2670000, torch.bfloat16, 0, 0, True),
    (14, 1, 2670, torch.float32, 0, 0, False),      # the ragged leaf
    (14, 1, 2670, torch.bfloat16, 0, 0, False),
    (14, 1, 2668, torch.float32, 0, 0, True),
    (14, 1, 2668, torch.bfloat16, 0, 0, False),     # not whole 8-lane units
    (14, 4, 131072, torch.float32, 0, 0, True),     # the stacked buffer
    (14, 4, 1000, torch.float32, 500, 0, True),     # system stride 1500
    (14, 4, 1000, torch.float32, 2, 0, False),      # system stride 1002
    (14, 1, 4096, torch.float32, 0, 1, False),      # 4 bytes off
    (14, 1, 4096, torch.float32, 0, 4, True),       # 16 bytes off
    (1, 1, 40, torch.float32, 0, 0, True),
])
def test_gram_row_load_width_choice(m, n_sys, n, dtype, pad, offset, want):
    x = _view(m, n_sys, n, dtype, pad, offset)
    assert tdevice.vector_lanes(x, x[m - 1]) is want
    if want:                                 # a query 4 bytes off is not
        q = torch.zeros(n_sys * n + 2, dtype=dtype)[2:].view(n_sys, n)
        assert tdevice.vector_lanes(x, q) is False


def test_gram_row_finds_the_query_slot():
    x = _view(14, 4, 1000, pad=500)
    for j in (0, 5, 13):
        assert tdevice.query_slot(x, x[j]) == j
    assert tdevice.query_slot(x, x[5].clone()) == -1
    assert tdevice.query_slot(x, torch.zeros(4, 1000)) == -1
    assert tdevice.query_slot(x, x[5].flip(0)) == -1
    flat = _view(3, 1, 8)
    assert tdevice.query_slot(flat, flat[2]) == 2


def _grid(wrapper, units, n_sys, sms):
    """The CTAs per system that ``wrapper`` (K4's or K5's) asks for."""
    return tdevice.grid_ctas(units, n_sys, sms, wrapper.CTAS_PER_SM,
                             wrapper.THREADS)


def test_gram_row_grid_fills_the_card_once():
    fill = tgram_row.CTAS_PER_SM * 132
    assert _grid(tgram_row, 2670000 // 4, 1, 132) == fill
    assert _grid(tgram_row, 131072 // 4, 4, 132) == -(-fill // 4)
    assert _grid(tgram_row, 1000, 1, 132) == 4       # one per 256 units
    assert _grid(tgram_row, 10, 1, 132) == 1
    assert _grid(tgram_row, 10, 65535, 132) == 1


# (m, S, n, dtype, pad, offset) -> 16-byte loads for K5, which reads the
# buffer alone: every row and system 16-byte aligned and n whole units.
# Only the n = 2670 leaf of the paper MLP is ragged; n = 40, 200 and 240
# are whole 16-byte units in fp32 and in bf16.
@pytest.mark.parametrize("m,n_sys,n,dtype,pad,offset,want", [
    (14, 1, 2670000, torch.float32, 0, 0, True),    # /l3/w
    (14, 1, 2670000, torch.bfloat16, 0, 0, True),
    (14, 1, 2670, torch.float32, 0, 0, False),      # the ragged leaf
    (14, 1, 2670, torch.bfloat16, 0, 0, False),
    (14, 1, 40, torch.float32, 0, 0, True),
    (14, 1, 200, torch.bfloat16, 0, 0, True),
    (14, 1, 240, torch.bfloat16, 0, 0, True),
    (14, 4, 1000, torch.float32, 4, 0, True),       # system stride 1004
    (14, 4, 1000, torch.bfloat16, 4, 0, False),     # 1004 not 8-lane units
    (14, 4, 1000, torch.float32, 1, 0, False),      # system stride 1001
    (14, 1, 4096, torch.float32, 0, 2, False),      # 8 bytes off
    (14, 1, 4096, torch.bfloat16, 0, 8, True),      # 16 bytes off
    (1, 3, 8, torch.bfloat16, 0, 0, True),
])
def test_combine_load_width_choice(m, n_sys, n, dtype, pad, offset, want):
    x = _view(m, n_sys, n, dtype, pad, offset)
    assert tdevice.vector_lanes(x) is want


def test_combine_grid_fills_the_card_once():
    fill = tcombine.CTAS_PER_SM * 132
    assert _grid(tcombine, 2670000 // 4, 1, 132) == fill
    assert _grid(tcombine, 131072 // 4, 4, 132) == -(-fill // 4)
    assert _grid(tcombine, 1000, 1, 132) == 4        # one per 256 units
    assert _grid(tcombine, 10, 65535, 132) == 1
