"""The port's CUDA kernels (the arena kernels K1-K3, the flat per-leaf
kernels K4-K6, flash attention K7 and its backward K7b) against their
plain PyTorch twins, on the card.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips (with a
reason) where there is no CUDA device, so every process collects the same
tests. Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: integer-valued data must match exactly (every fp32 sum is
exact in any order while every partial sum stays below 2**24 in magnitude:
the layouts of thousands of blocks draw values from {-1, 0, 1}); random data |diff| <= 1e-5 * max(1, max|twin|) (fp32
summation order over up to a few thousand lanes per block); two launches
on the same inputs must be bit-identical (no atomics). K7 on unit-normal
inputs, over the rows that see at least one key: fp32 within 2e-5 + 1e-5 *
|twin| (online softmax over key tiles against one softmax over the row);
bf16 within 1e-2 + 1.6e-2 * |twin| (one bf16 rounding step of the output,
2^-7 relative, plus the kernel's bf16 rounding of the softmax weights).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs.base import DMDConfig
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import leaves_with_paths
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.kernels import arena as ka
from repro_torch.kernels import combine as kc
from repro_torch.kernels import device as kd
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import gram as kg
from repro_torch.kernels import gram_row as kgr
from repro_torch.models.mlp_net import init_mlp
from repro_torch.train import paper_loop

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (these tests run the CUDA kernels)")
    return torch.device("cuda")


def _layout(blocks_per_sys, m, bn, dtype, integer, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nb = sum(blocks_per_sys)
    shape = (nb, m, bn)
    if integer:
        x = torch.randint(-8, 9, shape, generator=gen).float()
        c = torch.randint(-4, 5, (len(blocks_per_sys), m), generator=gen)
    else:
        x = torch.randn(shape, generator=gen)
        c = torch.randn((len(blocks_per_sys), m), generator=gen)
    bs = np.repeat(np.arange(len(blocks_per_sys)), blocks_per_sys)
    seg = ka.Segments.from_block_sys(bs, len(blocks_per_sys), device)
    return x.to(device, dtype), c.float().to(device), seg


def _compare(got, want, exact):
    if exact:
        assert torch.equal(got, want), (got - want).abs().max()
    else:
        bound = 1e-5 * max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= bound


@pytest.mark.parametrize("m", [3, 5, 14, 17, 32])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_twins(cuda, m, integer, dtype):
    x, c, seg = _layout([1, 3, 2, 40, 1], m, 512, dtype, integer, cuda)
    slot = m - 1
    q = x[:, slot, :]
    for anchor_first in (False, True):
        got = ka.gram_row(x, q, seg, anchor_first=anchor_first)
        want = ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                               anchor_first=anchor_first)
        _compare(got, want, integer)
        assert torch.equal(got, ka.gram_row(x, q, seg,
                                            anchor_first=anchor_first))
    for anchor in ({}, {"anchor_first": True}, {"anchor_mean": True}):
        got = ka.gram(x, seg, **anchor)
        want = ka.gram_ref(x, seg.block_sys, seg.n_sys, **anchor)
        _compare(got, want, integer and not anchor.get("anchor_mean"))
        assert torch.equal(got, ka.gram(x, seg, **anchor))
        assert torch.equal(got, got.transpose(1, 2))
    got = ka.combine(x, c, seg)
    want = ka.combine_ref(x, c, seg.block_sys)
    _compare(got, want, integer)
    assert torch.equal(got, ka.combine(x, c, seg))


@pytest.mark.parametrize("bn", [128, 384, 1024])
def test_kernels_other_block_widths(cuda, bn):
    x, c, seg = _layout([2, 1, 5], 14, bn, torch.float32, True, cuda)
    q = x[:, 3, :]
    _compare(ka.gram_row(x, q, seg, anchor_first=True),
             ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                             anchor_first=True), True)
    _compare(ka.gram(x, seg, anchor_first=True),
             ka.gram_ref(x, seg.block_sys, seg.n_sys, anchor_first=True),
             True)
    _compare(ka.combine(x, c, seg), ka.combine_ref(x, c, seg.block_sys),
             True)


def test_launch_counts_and_refusals(cuda):
    x, c, seg = _layout([1, 2], 4, 128, torch.float32, True, cuda)
    before = dict(ka.LAUNCHES)
    ka.gram_row(x, x[:, 0, :], seg)
    ka.gram(x, seg)
    ka.combine(x, c, seg)
    ka.combine(x, c, seg)
    assert {k: ka.LAUNCHES[k] - before[k] for k in before} == \
        {"gram_row": 1, "gram": 1, "combine": 2}
    with pytest.raises(ValueError):
        ka.gram(x.double(), seg)
    with pytest.raises(ValueError, match="devices"):
        ka.combine(x, c.cpu(), seg)
    cpu_seg = ka.Segments.from_block_sys([0, 1, 1], 2, "cpu")
    with pytest.raises(ValueError):
        ka.gram(x, cpu_seg)


def test_paper_loop_on_card_matches_cpu(cuda):
    """The slice at small size on the card and on the CPU, same injected
    weights: losses within rtol 2e-3 (the bound of the reference parity
    test: jumps amplify fp32 summation-order noise)."""
    X, Y = synthetic_regression(seed=0, n=64, n_out=130)
    cfg = DMDConfig(m=4, s=5, warmup_steps=5, cooldown_steps=2,
                    arena_block_n=128)
    params = init_mlp(torch.Generator().manual_seed(0), (6, 16, 40, 130),
                      device="cpu")
    before = dict(ka.LAUNCHES)
    on_card = paper_loop.train(X, Y, (6, 16, 40, 130), cfg, 30,
                               params=params, device=cuda)
    on_cpu = paper_loop.train(X, Y, (6, 16, 40, 130), cfg, 30,
                              params=params, device="cpu")
    assert ka.LAUNCHES["gram_row"] - before["gram_row"] == 16
    assert ka.LAUNCHES["combine"] - before["combine"] == 4
    np.testing.assert_allclose(on_card.losses, on_cpu.losses, rtol=2e-3)


# ---------------------------------------------------------------------------
# The flat per-leaf kernels K4-K6 (csrc/flat.cu)
# ---------------------------------------------------------------------------

def _flat(m, n_sys, n, dtype, integer, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if integer:
        x = torch.randint(-8, 9, (m, n_sys, n), generator=gen).float()
        c = torch.randint(-4, 5, (n_sys, m), generator=gen).float()
    else:
        x = torch.randn((m, n_sys, n), generator=gen)
        c = torch.randn((n_sys, m), generator=gen)
    return x.to(device, dtype), c.to(device)


@pytest.mark.parametrize("shape", [(1, 1, 40), (3, 1, 200), (14, 1, 240),
                                   (14, 1, 2670), (14, 1, 8000),
                                   (17, 4, 5000), (32, 2, 4097)])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_kernels_match_twins(cuda, shape, integer, dtype):
    m, n_sys, n = shape
    x, c = _flat(m, n_sys, n, dtype, integer, cuda)
    for slot in {0, m - 1}:
        for anchor_first in (False, True):
            got = kgr.gram_row(x, x[slot], anchor_first=anchor_first)
            want = kgr.gram_row_ref(x, x[slot], anchor_first=anchor_first)
            _compare(got, want, integer)
            assert torch.equal(got, kgr.gram_row(x, x[slot],
                                                 anchor_first=anchor_first))
            if anchor_first and slot == 0:
                assert torch.equal(got, torch.zeros_like(got))
    for anchor_first in (False, True):
        got = kg.gram(x, anchor_first=anchor_first)
        _compare(got, kg.gram_ref(x, anchor_first=anchor_first), integer)
        assert torch.equal(got, kg.gram(x, anchor_first=anchor_first))
        assert torch.equal(got, got.transpose(1, 2))
    got = kc.combine(x, c)
    _compare(got, kc.combine_ref(x, c), integer)
    assert torch.equal(got, kc.combine(x, c))


def test_flat_kernels_read_strided_stacks(cuda):
    """A stacked (m, S, n) buffer and a query that is a slot of it go in
    where they lie: the same numbers as on contiguous copies."""
    x, c = _flat(14, 4, 1000, torch.float32, True, cuda)
    wide = torch.zeros((14, 4, 1500), device=cuda)
    wide[:, :, :1000] = x
    view = wide[:, :, :1000]                 # system stride 1500, not 1000
    _compare(kgr.gram_row(view, view[5], anchor_first=True),
             kgr.gram_row_ref(x, x[5], anchor_first=True), True)
    _compare(kg.gram(view, anchor_first=True),
             kg.gram_ref(x, anchor_first=True), True)
    _compare(kc.combine(view, c), kc.combine_ref(x, c), True)


def test_flat_launch_counts_and_per_leaf_loop(cuda):
    """Each wrapper counts its launches; the per-leaf paper loop at small
    size launches K4 once per leaf per record and K5 once per leaf per
    jump, and its losses match the CPU run's within rtol 2e-3."""
    X, Y = synthetic_regression(seed=0, n=64, n_out=130)
    cfg = DMDConfig(m=4, s=5, warmup_steps=5, cooldown_steps=2, arena=False)
    params = init_mlp(torch.Generator().manual_seed(0), (6, 16, 40, 130),
                      device="cpu")
    before = {**kgr.LAUNCHES, **kc.LAUNCHES, **kg.LAUNCHES,
              **ka.LAUNCHES}
    on_card = paper_loop.train(X, Y, (6, 16, 40, 130), cfg, 30,
                               params=params, device=cuda)
    on_cpu = paper_loop.train(X, Y, (6, 16, 40, 130), cfg, 30,
                              params=params, device="cpu")
    after = {**kgr.LAUNCHES, **kc.LAUNCHES, **kg.LAUNCHES, **ka.LAUNCHES}
    diff = {k: after[k] - before[k] for k in before}
    assert diff == {"flat_gram_row": 16 * 6, "flat_combine": 4 * 6,
                    "flat_gram": 0, "gram_row": 0, "gram": 0, "combine": 0}
    np.testing.assert_allclose(on_card.losses, on_cpu.losses, rtol=2e-3)


# (B, Sq, Sk, H, K, d, causal, window): the serve prefill shapes of
# TinyLlama, the reference's kernel-test cases, and the edges (d 16 and
# 128, GQA rep 1 and 8, ragged S, Sq != Sk both ways, windows)
FLASH_CASES = [
    (1, 16, 16, 32, 4, 64, True, 0),
    (4, 64, 64, 32, 4, 64, True, 0),
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (1, 100, 100, 2, 1, 32, False, 0),
    (1, 64, 192, 2, 2, 128, True, 0),
    (1, 192, 64, 8, 1, 16, True, 0),
    (2, 100, 100, 16, 2, 16, False, 40),
    (1, 333, 333, 8, 8, 128, True, 100),
]


def _flash_inputs(case, dtype, device, seed=0):
    B, Sq, Sk, H, K, d, _, _ = case
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device, dtype) for shape in ((B, Sq, H, d), (B, Sk, K, d),
                                     (B, Sk, K, d))]


def _seen_rows(Sq, Sk, causal, window):
    return kf._mask(Sq, Sk, causal, window, "cpu").any(dim=1)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_twin(cuda, case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _flash_inputs(case, dtype, cuda)
    n0 = kf.LAUNCHES["flash_attention"]
    got = kf.flash_attention(q, k, v, causal=causal, window=window)
    again = kf.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert kf.LAUNCHES["flash_attention"] == n0 + 2
    assert torch.equal(got, again)
    assert got.shape == q.shape and got.dtype == dtype
    assert torch.isfinite(got.float()).all()
    want = kf.flash_attention_ref(q, k, v, causal=causal, window=window)
    rows = _seen_rows(case[1], case[2], causal, window).to(cuda)
    atol, rtol = (2e-5, 1e-5) if dtype == torch.float32 else (1e-2, 1.6e-2)
    torch.testing.assert_close(got[:, rows].float(), want[:, rows].float(),
                               atol=atol, rtol=rtol)


def test_flash_attention_reads_strided_views(cuda):
    """q, k and v as head slices of one fused (B, S, H + 2K, d) projection:
    read through their strides, no copy, same result as contiguous."""
    B, S, H, K, d = 2, 96, 8, 2, 64
    g = torch.Generator(device="cpu").manual_seed(0)
    qkv = torch.randn((B, S, H + 2 * K, d), generator=g).to(
        cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    got = kf.flash_attention(q, k, v)
    want = kf.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    assert torch.equal(got, want)


def test_flash_attention_refusals(cuda):
    q = torch.randn((1, 8, 4, 64), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        kf.flash_attention(q[..., :40], q[..., :40], q[..., :40])
    with pytest.raises(ValueError, match="multiple"):
        kf.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="lse"):
        kf.flash_attention_bwd(q, q, q, q, q, None)
    with pytest.raises(ValueError, match="devices"):
        kf.flash_attention(q.detach(), q.detach().cpu(), q.detach().cpu())
    odd = torch.zeros((1, 8, 4 * 64 + 4), device=cuda)[..., 4:]
    odd = odd.view(1, 8, 4, 64)                   # rows 16 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        kf.flash_attention(odd, odd, odd)


# The Hopper design of K7 (bf16 at d 64 and 128; 128 queries per CTA, 128
# keys per tile at d 64 and 64 at d 128) at the edges of its tiles: lengths
# 127 ... 257 under every mask, GQA rep 1 and 8, Sq != Sk both ways
WGMMA_CASES = [
    case for d in (64, 128) for case in
    [(1, s, s, 8, 1, d, True, 0) for s in (127, 128, 129, 257)]
    + [(2, s, s, 4, 4, d, False, 0) for s in (127, 129)]
    + [(1, 257, 257, 8, 2, d, True, 100), (1, 129, 257, 8, 1, d, True, 0),
       (1, 257, 127, 8, 8, d, True, 0), (1, 127, 129, 4, 1, d, False, 64)]]


@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_design_at_tile_edges(cuda, case):
    causal, window = case[6], case[7]
    q, k, v = _flash_inputs(case, torch.bfloat16, cuda, seed=1)
    before = dict(kf.LAUNCHES)
    got = kf.flash_attention(q, k, v, causal=causal, window=window)
    again = kf.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert {k_: kf.LAUNCHES[k_] - before[k_] for k_ in before} == {
        "flash_attention": 2, "flash_attention_wgmma": 2,
        "flash_attention_offset": 0, "flash_attention_bwd": 0,
        "flash_attention_bwd_wgmma": 0, "flash_attention_bwd_offset": 0}
    assert torch.equal(got, again)
    want = kf.flash_attention_ref(q, k, v, causal=causal, window=window)
    rows = _seen_rows(case[1], case[2], causal, window).to(cuda)
    torch.testing.assert_close(got[:, rows].float(), want[:, rows].float(),
                               atol=1e-2, rtol=1.6e-2)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_wgmma_reads_strided_views(cuda, d):
    """Through the TMA tensor maps: q, k and v as head slices of one fused
    projection give the same bits as contiguous copies."""
    g = torch.Generator(device="cpu").manual_seed(d)
    qkv = torch.randn((2, 257, 12, d), generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = kf.flash_attention(q, k, v)
    assert torch.equal(got, kf.flash_attention(q.contiguous(), k.contiguous(),
                                               v.contiguous()))
    want = kf.flash_attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2,
                               rtol=1.6e-2)


def test_flash_design_counter(cuda):
    """Only bf16 at d 64 and 128 counts as the wgmma design."""
    for dtype, d, wgmma in ((torch.bfloat16, 64, 1), (torch.bfloat16, 128, 1),
                            (torch.bfloat16, 32, 0), (torch.float32, 64, 0)):
        q = torch.randn((1, 64, 4, d), device=cuda).to(dtype)
        n0 = dict(kf.LAUNCHES)
        kf.flash_attention(q, q[:, :, :2], q[:, :, :2])
        assert kf.LAUNCHES["flash_attention"] == n0["flash_attention"] + 1
        assert kf.LAUNCHES["flash_attention_wgmma"] == \
            n0["flash_attention_wgmma"] + wgmma


# K4's two load paths: (m, S, n, 16-byte loads?)
K4_PATHS = [(14, 1, 2670, False), (14, 1, 2672 * 8, True),
            (14, 4, 131072, True), (17, 2, 5000, True), (3, 1, 41, False)]


@pytest.mark.parametrize("shape", K4_PATHS)
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_gram_row_load_paths(cuda, shape, integer, dtype):
    m, n_sys, n, vec = shape
    x, _ = _flat(m, n_sys, n, dtype, integer, cuda, seed=3)
    per = 16 // x.element_size()
    assert kd.vector_lanes(x, x[m - 1]) is (vec and n % per == 0)
    for slot in (0, m - 1):
        for anchor_first in (False, True):
            got = kgr.gram_row(x, x[slot], anchor_first=anchor_first)
            want = kgr.gram_row_ref(x, x[slot], anchor_first=anchor_first)
            _compare(got, want, integer)
            assert torch.equal(got, kgr.gram_row(x, x[slot],
                                                 anchor_first=anchor_first))
            # the query as a copy, not a slot of the buffer
            _compare(kgr.gram_row(x, x[slot].clone(),
                                  anchor_first=anchor_first), want, integer)
    _assert_tickets_zero(x.device)


def _assert_tickets_zero(device):
    """K1 and K4 leave their per-system tickets at zero."""
    torch.cuda.synchronize()
    assert not kd.tickets(device, kd.stream(), 1).any()


# K1's design (csrc/arena.cu arena_row): systems of 1 block and of
# thousands, systems with no block (first, inner, last), the query as the
# buffer's slot and as a separate copy
K1_LAYOUTS = [[1, 3, 2, 40, 1], [0, 1, 2000, 0, 5, 1, 0]]


@pytest.mark.parametrize("bn", [128, 384, 1024])
@pytest.mark.parametrize("m", [3, 5, 14, 17, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arena_gram_row_design(cuda, m, bn, dtype):
    g = torch.Generator(device=cuda).manual_seed(m * 7919 + bn)
    for blocks in K1_LAYOUTS:
        nb = sum(blocks)
        seg = ka.Segments.from_block_sys(
            np.repeat(np.arange(len(blocks)), blocks), len(blocks), cuda)
        for integer in (True, False):
            x = (torch.randint(-1, 2, (nb, m, bn), generator=g, device=cuda)
                 .float() if integer else
                 torch.randn((nb, m, bn), generator=g, device=cuda)).to(dtype)
            assert kd.vector_lanes(x, x[:, m - 1, :])   # bn: 128-lane units
            for slot in {0, m - 1}:
                view = x[:, slot, :]
                assert kd.query_slot(x, view, axis=1) == slot
                for q in (view, view.clone()):
                    for anchor_first in (False, True):
                        got = ka.gram_row(x, q, seg, anchor_first=anchor_first)
                        want = ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                               anchor_first=anchor_first)
                        _compare(got, want, integer)
                        assert torch.equal(got, ka.gram_row(
                            x, q, seg, anchor_first=anchor_first))
                        if anchor_first and slot == 0:
                            assert not got.any()
                        empty = [s for s, b in enumerate(blocks) if not b]
                        assert not got[empty].any()
            _assert_tickets_zero(x.device)


def test_arena_gram_row_one_lane_loads(cuda):
    """An arena whose rows are not whole 16-byte units (bn = 100 bf16) or
    a query 4 bytes off takes one-lane loads: the same numbers."""
    for dtype, bn, shift in ((torch.bfloat16, 100, 0),
                             (torch.float32, 128, 1)):
        x, _, seg = _layout([1, 3, 2, 40, 1], 14, bn, dtype, True, cuda)
        q = torch.zeros(x.shape[0] * bn + shift, dtype=dtype,
                        device=cuda)[shift:].view(x.shape[0], bn)
        q.copy_(x[:, 6, :])
        assert not kd.vector_lanes(x, q)
        for anchor_first in (False, True):
            _compare(ka.gram_row(x, q, seg, anchor_first=anchor_first),
                     ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                     anchor_first=anchor_first), True)
    _assert_tickets_zero(x.device)


# K5's load paths: K4's shapes and the paper's ragged leaves
# (m, S, n, 16-byte loads when n is whole units?)
K5_PATHS = K4_PATHS + [(14, 1, 40, True), (14, 1, 200, True),
                       (14, 1, 240, True)]


@pytest.mark.parametrize("shape", K5_PATHS)
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_combine_load_paths(cuda, shape, integer, dtype):
    m, n_sys, n, vec = shape
    x, c = _flat(m, n_sys, n, dtype, integer, cuda, seed=4)
    per = 16 // x.element_size()
    assert kd.vector_lanes(x) is (vec and n % per == 0)
    got = kc.combine(x, c)
    _compare(got, kc.combine_ref(x, c), integer)
    assert torch.equal(got, kc.combine(x, c))
    # a strided stack: systems 16 bytes further apart keep the load width,
    # one element further apart take one-lane loads; the sums run in the
    # same order either way, so the bits do not change
    for pad, wide_loads in ((per, kd.vector_lanes(x)), (1, False)):
        wide = torch.zeros((m, n_sys, n + pad), dtype=dtype, device=cuda)
        wide[:, :, :n] = x
        view = wide[:, :, :n]
        assert kd.vector_lanes(view) is wide_loads
        assert torch.equal(kc.combine(view, c), got)


# ---------------------------------------------------------------------------
# K3 and K6 (csrc/gram.cuh: the register outer product on K1's and K4's
# grids). Every case against the twin: within 1e-5 of each system's largest
# entry on random data, exact on integer data in {-1, 0, 1} (every partial
# sum stays below 2**24), repeat launches bit-identical, the result exactly
# symmetric, the tickets left at zero.
# ---------------------------------------------------------------------------

GRAM_M = [1, 2, 8, 13, 14, 16, 17, 32]


@functools.lru_cache(maxsize=None)
def _paper_blocks():
    """Blocks per system of the paper bucket's real table (5633 blocks)."""
    params = init_mlp(torch.Generator().manual_seed(0), PAPER_SIZES,
                      device="cpu")
    (bucket,) = DMDAccelerator(DMDConfig(), device="cpu").arena_for(
        params).values()
    return tuple(np.bincount(bucket.block_sys(),
                             minlength=bucket.n_sys).tolist())


# systems of 1 block and of thousands; systems with no block (first, inner,
# last); the paper bucket; one system (an all-zeros table) over every CTA
def _gram_layouts():
    return [[1, 3, 2, 40, 1], [0, 1, 2000, 0, 5, 1, 0],
            list(_paper_blocks()), [1000]]


def _close_per_system(got, want):
    n = want.shape[0]
    diff = (got - want).abs().reshape(n, -1).amax(dim=1)
    limit = 1e-5 * want.abs().reshape(n, -1).amax(dim=1).clamp_min(1.0)
    assert bool((diff <= limit).all()), float((diff - limit).max())


def _check_gram(got, again, want, exact):
    assert torch.equal(got, again)
    assert torch.equal(got, got.transpose(-1, -2))
    if exact:
        assert torch.equal(got, want), float((got - want).abs().max())
    else:
        _close_per_system(got, want)


def _draw(shape, integer, dtype, g):
    x = (torch.randint(-1, 2, shape, generator=g, device=g.device).float()
         if integer else torch.randn(shape, generator=g, device=g.device))
    return x.to(dtype)


@pytest.mark.parametrize("bn", [128, 512, 640])
@pytest.mark.parametrize("m", GRAM_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arena_gram_design(cuda, m, bn, dtype):
    g = torch.Generator(device=cuda).manual_seed(m * 7919 + bn)
    before = ka.LAUNCHES["gram"]
    calls = 0
    for blocks in _gram_layouts():
        nb = sum(blocks)
        seg = ka.Segments.from_block_sys(
            np.repeat(np.arange(len(blocks)), blocks), len(blocks), cuda)
        empty = [s for s, b in enumerate(blocks) if not b]
        for integer in (True, False):
            x = _draw((nb, m, bn), integer, dtype, g)
            assert kd.vector_lanes(x)               # bn: 128-lane units
            for anchor in ({}, {"anchor_first": True}, {"anchor_mean": True}):
                got = ka.gram(x, seg, **anchor)
                want = ka.gram_ref(x, seg.block_sys, seg.n_sys, **anchor)
                _check_gram(got, ka.gram(x, seg, **anchor), want,
                            integer and not anchor.get("anchor_mean"))
                assert not got[empty].any()
                if anchor.get("anchor_first"):
                    assert not got[:, 0].any() and not got[:, :, 0].any()
                calls += 2
            _assert_tickets_zero(x.device)
            del x
    assert ka.LAUNCHES["gram"] - before == calls      # one launch a call


def test_arena_gram_one_lane_loads(cuda):
    """Rows that are not whole 16-byte units (bn = 100 bf16) or a buffer 4
    bytes off take one-lane loads: the same checks."""
    blocks = [1, 3, 2, 40, 1]
    seg = ka.Segments.from_block_sys(
        np.repeat(np.arange(len(blocks)), blocks), len(blocks), cuda)
    nb = sum(blocks)
    for dtype, bn, shift in ((torch.bfloat16, 100, 0),
                             (torch.float32, 128, 1)):
        for m in (5, 14, 17):
            x = torch.zeros(nb * m * bn + shift, dtype=dtype,
                            device=cuda)[shift:].view(nb, m, bn)
            x.copy_(torch.randint(-1, 2, (nb, m, bn), device=cuda))
            assert not kd.vector_lanes(x)
            for anchor in ({}, {"anchor_first": True}, {"anchor_mean": True}):
                got = ka.gram(x, seg, **anchor)
                _check_gram(got, ka.gram(x, seg, **anchor),
                            ka.gram_ref(x, seg.block_sys, seg.n_sys, **anchor),
                            not anchor.get("anchor_mean"))
            _assert_tickets_zero(x.device)


@pytest.mark.parametrize("m", GRAM_M)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_gram_design(cuda, m, dtype):
    """Ragged leaves (n 40, 2670: one lane where n is not whole 16-byte
    units), whole units, one system over every CTA (n = 2**20), several
    systems, and the strided (m, 4, 131072) stack read where it lies (its
    system stride 16 bytes longer keeps 16-byte loads, 4 bytes longer takes
    one lane)."""
    g = torch.Generator(device=cuda).manual_seed(m)
    per = 16 // torch.empty((), dtype=dtype).element_size()
    before = kg.LAUNCHES["flat_gram"]
    calls = 0
    for n_sys, n, pad in ((1, 40, 0), (1, 2670, 0), (1, 4096, 0),
                          (1, 1 << 20, 0), (3, 5000, 0), (4, 131072, per),
                          (4, 131072, 1)):
        for integer in (True, False):
            x = _draw((m, n_sys, n), integer, dtype, g)
            if pad:
                wide = torch.zeros((m, n_sys, n + pad), dtype=dtype,
                                   device=cuda)
                wide[:, :, :n] = x
                x = wide[:, :, :n]
            assert kd.vector_lanes(x) is (n % per == 0 and pad != 1)
            for anchor_first in (False, True):
                got = kg.gram(x, anchor_first=anchor_first)
                _check_gram(got, kg.gram(x, anchor_first=anchor_first),
                            kg.gram_ref(x, anchor_first=anchor_first),
                            integer)
                if anchor_first:
                    assert not got[:, 0].any() and not got[:, :, 0].any()
                calls += 2
            _assert_tickets_zero(x.device)
            del x
    assert kg.LAUNCHES["flat_gram"] - before == calls


# -- the Trainer path: differentiable combines, captured train steps --------

def _paper_arena(cuda, dtype, seed=0):
    """The paper bucket's (5633, 14, 512) buffer, block table and c."""
    params = init_mlp(torch.Generator().manual_seed(0), PAPER_SIZES,
                      device=cuda)
    (bucket,) = DMDAccelerator(DMDConfig(), device=cuda).arena_for(
        params).values()
    seg = bucket.tables_on(cuda)
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((bucket.n_blocks, bucket.m, bucket.block_n),
                    generator=g, device=cuda).to(dtype)
    c = torch.randn((seg.n_sys, bucket.m), generator=g, device=cuda)
    return x, c, seg


def _close_rows(got, want, rtol=1e-5):
    """|got - want| <= rtol * max(1, max |want|) within each row."""
    diff = (got - want).abs().amax(dim=1)
    assert bool((diff <= rtol * want.abs().amax(dim=1).clamp_min(1.0)).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_arena_combine_backward_through_k1(cuda, dtype):
    """K2's gradient in c is one K1 launch (counted under gram_row_bwd) at
    the paper arena: against the twin's autograd on the cotangent as K1
    sees it (rounded to the buffer's dtype), rtol 1e-5 per system; for bf16
    also against the unrounded cotangent, within 1e-2 per system (the
    documented bf16 rounding of the query)."""
    x, c, seg = _paper_arena(cuda, dtype)
    r = torch.randn((x.shape[0] * x.shape[2],), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    b0, k0 = ka.BWD_LAUNCHES["gram_row_bwd"], ka.LAUNCHES["gram_row"]
    cr = c.clone().requires_grad_(True)
    (got,) = torch.autograd.grad((ka.combine(x, cr, seg) * r).sum(), cr)
    assert ka.BWD_LAUNCHES["gram_row_bwd"] - b0 == 1
    assert ka.LAUNCHES["gram_row"] - k0 == 1
    rq = r.to(dtype).float()
    ct = c.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        (ka.combine_ref(x, ct, seg.block_sys) * rq).sum(), ct)
    _close_rows(got, want)
    if dtype == torch.bfloat16:
        ct = c.clone().requires_grad_(True)
        (full,) = torch.autograd.grad(
            (ka.combine_ref(x, ct, seg.block_sys) * r).sum(), ct)
        _close_rows(got, full, rtol=1e-2)
    _assert_tickets_zero(cuda)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flat_combine_backward_through_k4(cuda, dtype):
    """K5's gradient in c is one K4 launch (flat_gram_row_bwd) at /l3/w,
    (14, 1, 2670000), and on a stacked (14, 4, 131072) buffer; tolerances
    as for K2."""
    g = torch.Generator(device=cuda).manual_seed(5)
    for shape in ((14, 1, 2670000), (14, 4, 131072)):
        x = torch.randn(shape, generator=g, device=cuda).to(dtype)
        c = torch.randn((shape[1], shape[0]), generator=g, device=cuda)
        r = torch.randn((shape[1], shape[2]), generator=g, device=cuda)
        b0 = kgr.BWD_LAUNCHES["flat_gram_row_bwd"]
        cr = c.clone().requires_grad_(True)
        (got,) = torch.autograd.grad((kc.combine(x, cr) * r).sum(), cr)
        assert kgr.BWD_LAUNCHES["flat_gram_row_bwd"] - b0 == 1
        ct = c.clone().requires_grad_(True)
        (want,) = torch.autograd.grad(
            (kc.combine_ref(x, ct) * r.to(dtype).float()).sum(), ct)
        _close_rows(got, want)
        if dtype == torch.bfloat16:
            ct = c.clone().requires_grad_(True)
            (full,) = torch.autograd.grad((kc.combine_ref(x, ct) * r).sum(),
                                          ct)
            _close_rows(got, full, rtol=1e-2)
        del x
    _assert_tickets_zero(cuda)


def _mlp_trainer(cuda, *, arena=True, graphs=True, controller=None,
                 **dmd):
    from repro_torch.configs.base import (ArchConfig, DMDControllerConfig,
                                          ModelConfig, OptimizerConfig,
                                          TrainConfig)
    from repro_torch.models.mlp_net import MLPModel
    from repro_torch.train import Trainer
    acfg = ArchConfig(
        model=ModelConfig(name="mlp", family="mlp"),
        dmd=DMDConfig(m=4, s=5, warmup_steps=5, cooldown_steps=2,
                      arena_block_n=128, arena=arena,
                      controller=controller or DMDControllerConfig(), **dmd),
        optimizer=OptimizerConfig(name="adam", lr=1e-3),
        train=TrainConfig(global_batch=64, seq_len=1), shapes=())
    X, Y = synthetic_regression(seed=0, n=96, n_out=130)
    batch = {"x": torch.tensor(X[:64], device=cuda),
             "y": torch.tensor(Y[:64], device=cuda)}
    val = {"x": torch.tensor(X[64:], device=cuda),
           "y": torch.tensor(Y[64:], device=cuda)}
    tr = Trainer(MLPModel((6, 16, 40, 130)), acfg, device=cuda,
                 cuda_graphs=graphs,
                 val_batch=val if controller is not None else None)
    return tr, batch


def _state_tensors(st):
    from repro_torch.core.paths import leaves_with_paths
    return [x for _, x in leaves_with_paths(st)]


@pytest.mark.parametrize("arena", [True, False])
def test_captured_train_step_bit_identical_to_eager(cuda, arena):
    """A train step captured as a CUDA graph and replayed writes the same
    bits into every state tensor (params, moments, step, ring buffers,
    Grams) as the same step run eagerly on a copy of the same state: the
    plain step and a record step (slot 0, K1 or K4 inside the graph); the
    tickets are left at zero after the replays."""
    from repro_torch.core.paths import map_with_paths
    from repro_torch.train import loop
    from repro_torch.train.step import state_resident
    tr, batch = _mlp_trainer(cuda, arena=arena)
    st = state_resident(tr.acc, tr.acfg, tr.init_state())
    graphed = loop._GraphedSteps(tr.train_step, cuda)
    # step 1: the plain graph's capture; step 13: slot 0's (its warm-up
    # ran at step 7)
    checked = []
    for t in range(14):
        slots = tr.acc.slots(t)
        key = loop.graph_key(slots)
        twin = None
        if key in graphed.warm and key not in graphed.graphs:
            twin = map_with_paths(lambda _, x: x.clone(), st)
            tr.train_step(twin, batch, slots)
        graphed(st, batch, slots, key)
        if twin is not None:
            torch.cuda.synchronize()
            for a, b in zip(_state_tensors(st), _state_tensors(twin)):
                assert torch.equal(a, b)
            checked.append((t, key))
        if tr.acc.apply_groups(t):
            st, _ = tr.dmd_step(st, tr.acc.relax_vector(t),
                                groups=tr.acc.apply_groups(t))
    assert checked == [(1, loop.PLAIN), (13, (0,))]
    assert graphed.stats["captured"] == 2
    torch.cuda.synchronize()
    for st_handle in (graphed.side.cuda_stream, kd.stream()):
        assert not kd.tickets(cuda, st_handle, 1).any()


def test_graphed_fit_matches_eager_fit_and_counts(cuda):
    """The whole Trainer run with graphs equals the eager run bit for bit
    (per-step losses and final params), and the launch counts are the
    kernels that ran: K1 once per record step, K2 once per jump."""
    runs = {}
    for graphs in (True, False):
        tr, batch = _mlp_trainer(cuda, graphs=graphs)
        ka.reset_launches()
        losses = []
        st = tr.fit(iter(lambda: batch, None), 30,
                    on_metrics=lambda t, m: losses.append(m["loss"]))
        torch.cuda.synchronize()
        runs[graphs] = (torch.stack(losses), st, dict(ka.LAUNCHES))
        n_rec = sum(tr.acc.should_record(t) for t in range(30))
        n_jump = sum(tr.acc.should_apply(t) for t in range(30))
        assert runs[graphs][2] == {"gram_row": n_rec, "gram": 0,
                                   "combine": n_jump}
    assert torch.equal(runs[True][0], runs[False][0])
    for a, b in zip(_state_tensors(runs[True][1].params),
                    _state_tensors(runs[False][1].params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("when", ["mid", "jump"])
@pytest.mark.parametrize("arena", [True, False])
def test_graphed_fit_resumes_bit_exactly(cuda, tmp_path, arena, when):
    """A graphed Trainer preempted by SIGTERM (mid-window, or on a jump
    step) saves, and a fresh Trainer resumes from the checkpoint with new
    graphs: its per-step losses and its final state (params, moments,
    step, buffers, Grams) equal the uninterrupted graphed run's bit for
    bit; the two halves launch K1 / K4 once per record and K2 / K5 once
    per jump; the tickets are left at zero."""
    import signal
    steps = 30
    tr, batch = _mlp_trainer(cuda, arena=arena)
    acc = tr.acc
    j1 = next(t for t in range(steps) if acc.apply_groups(t))
    at = next(t for t in range(j1 + 1, steps)
              if (acc.apply_groups(t) if when == "jump" else
                  acc.should_record(t) and acc.slot(t) >= 1
                  and not acc.apply_groups(t)))
    want = []
    full = tr.fit(iter(lambda: batch, None), steps,
                  on_metrics=lambda t, m: want.append(m["loss"]))
    for counter in (ka.LAUNCHES, kgr.LAUNCHES, kc.LAUNCHES):
        for k in counter:
            counter[k] = 0

    def bomb(t, m):
        if t == at:
            signal.raise_signal(signal.SIGTERM)
    tr_b, _ = _mlp_trainer(cuda, arena=arena)
    tr_b.checkpoint_dir = str(tmp_path)
    try:
        st_b = tr_b.fit(iter(lambda: batch, None), steps, on_metrics=bomb)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert int(st_b.step) == at + 1
    tr_c, _ = _mlp_trainer(cuda, arena=arena)
    tr_c.checkpoint_dir = str(tmp_path)
    got = []
    st_c = tr_c.fit(iter(lambda: batch, None), steps,
                    on_metrics=lambda t, m: got.append(m["loss"]))
    torch.cuda.synchronize()
    assert tr_c.graph_stats["captured"] >= 1
    assert torch.equal(torch.stack(got), torch.stack(want[at + 1:]))
    a, b = _state_tensors(full), _state_tensors(st_c)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    n_rec = sum(acc.should_record(t) for t in range(steps))
    n_jump = sum(acc.should_apply(t) for t in range(steps))
    if arena:
        assert ka.LAUNCHES == {"gram_row": n_rec, "gram": 0,
                               "combine": n_jump}
    else:
        n_leaf = 6
        assert kgr.LAUNCHES["flat_gram_row"] == n_rec * n_leaf
        assert kc.LAUNCHES["flat_combine"] == n_jump * n_leaf
    _assert_tickets_zero(cuda)


def test_gated_trainer_meta_backward_on_card(cuda):
    """The gated, meta-tuned Trainer on the card: one K2 and one K1 (as
    K2's backward) per jump, knobs finite and inside their bands."""
    from repro_torch.configs.base import DMDControllerConfig
    ctrl = DMDControllerConfig(enabled=True, eval_rows=0, val_gate=True,
                               shrink_levels=(0.5, 0.25), meta_lr=0.25)
    tr, batch = _mlp_trainer(cuda, controller=ctrl)
    ka.reset_launches()
    st = tr.fit(iter(lambda: batch, None), 30)
    n_rec = sum(tr.acc.should_record(t) for t in range(30))
    n_jump = sum(tr.acc.should_apply(t) for t in range(30))
    assert ka.LAUNCHES == {"gram_row": n_rec + n_jump, "gram": 0,
                           "combine": n_jump}
    assert ka.BWD_LAUNCHES["gram_row_bwd"] == n_jump
    c = st.controller
    assert int((c.accepts + c.scaled + c.rejects).sum()) == n_jump
    assert 0.0 <= float(c.ridge_eff[0]) <= ctrl.ridge_max
    assert ctrl.relax_floor <= float(c.relax_eff[0]) <= 1.0


@pytest.mark.parametrize("grid", [(48, 24), (96, 48)])
def test_pollutant_march_on_card_matches_cpu(cuda, grid):
    """The batched march on the card against the port's CPU march of the
    same samples: each sample's iteration count equal or off by one, c3
    within 5 * tol absolute (the CPU tests' bound against the reference;
    torch runs the same one-op kernels on both, so equal is expected)."""
    from repro_torch.data import pollutant as pol
    nx, ny = grid
    p = pol.sample_params(6, seed=1)
    X, Y = pol.make_grid(nx, ny)
    eta, f, fp = pol.solve_blasius_batch(p[:, 3], p[:, 4], p[:, 5])
    ux, uy = zip(*(pol.velocity_field(r[3], r[4], r[5], X, Y,
                                      (eta, f[i], fp[i]))
                   for i, r in enumerate(p)))
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        np.stack(ux), np.stack(uy), p[:, 2], p[:, 0], p[:, 1],
        *pol.source_fields(X, Y))]
    dx, dy, tol = 2.0 / (nx - 1), 1.0 / (ny - 1), 1e-5
    *_, c3, it = pol.march(*args, dx, dy, n_iter=4000, tol=tol)
    *_, c3_card, it_card = pol.march(*(a.to(cuda) for a in args), dx, dy,
                                     n_iter=4000, tol=tol)
    assert (it_card.cpu() - it).abs().max() <= 1, (it, it_card)
    assert float((c3_card.cpu() - c3).abs().max()) <= 5 * tol
    data = pol.generate_dataset(n_samples=4, nx=nx, ny=ny, n_points=100,
                                device=cuda)
    want = pol.generate_dataset(n_samples=4, nx=nx, ny=ny, n_points=100,
                                device="cpu")
    np.testing.assert_array_equal(data["X"], want["X"])
    np.testing.assert_allclose(data["Y"], want["Y"], rtol=1e-5, atol=1e-5)


# -- bucket scope and eig mode (DESIGN.md §9; the paper's classic DMD) -------

@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bucket_scope_kernels_at_the_paper_arena(cuda, integer, dtype):
    """K1, K2 and K3 with the paper bucket's bucket-scope table (all 5633
    blocks on one system, so every CTA of K1's and K3's grids feeds the
    one ticket) against their twins: integer data in {-1, 0, 1} exact,
    random data within 1e-5 of max(1, |twin|); repeat launches
    bit-identical; K1's row is the sum of the leaf-scope rows (exact on
    integer data); the tickets are left at zero."""
    params = init_mlp(torch.Generator().manual_seed(0), PAPER_SIZES,
                      device=cuda)
    (bucket,) = DMDAccelerator(DMDConfig(scope="bucket"),
                               device=cuda).arena_for(params).values()
    seg = bucket.tables_on(cuda, "bucket")
    leaf = bucket.tables_on(cuda)
    assert seg.n_sys == 1 and seg.sys_off.tolist() == [0, 5633]
    g = torch.Generator(device=cuda).manual_seed(3)
    shape = (bucket.n_blocks, bucket.m, bucket.block_n)
    x = (torch.randint(-1, 2, shape, generator=g, device=cuda).float()
         if integer else torch.randn(shape, generator=g, device=cuda))
    x = x.to(dtype)
    c = torch.randn((1, bucket.m), generator=g, device=cuda)
    q = x[:, 13, :]
    for anchor_first in (False, True):
        got = ka.gram_row(x, q, seg, anchor_first=anchor_first)
        assert got.shape == (1, 14)
        _compare(got, ka.gram_row_ref(x, q, seg.block_sys, 1,
                                      anchor_first=anchor_first), integer)
        assert torch.equal(got, ka.gram_row(x, q, seg,
                                            anchor_first=anchor_first))
        rows = ka.gram_row(x, q, leaf, anchor_first=anchor_first)
        if integer:
            assert torch.equal(got, rows.sum(dim=0, keepdim=True))
    for anchor in ({}, {"anchor_first": True}, {"anchor_mean": True}):
        got = ka.gram(x, seg, **anchor)
        assert got.shape == (1, 14, 14)
        _compare(got, ka.gram_ref(x, seg.block_sys, 1, **anchor),
                 integer and "anchor_mean" not in anchor)
        assert torch.equal(got, ka.gram(x, seg, **anchor))
    w = ka.combine(x, c, seg)
    _compare(w, ka.combine_ref(x, c, seg.block_sys), False)
    assert torch.equal(w, ka.combine(x, c.expand(leaf.n_sys, -1)
                                     .contiguous(), leaf))
    _assert_tickets_zero(cuda)


@pytest.mark.parametrize("when", ["mid", "jump"])
def test_bucket_eig_graphed_fit_resumes_bit_exactly(cuda, tmp_path, when):
    """The paper's eig mode at bucket scope, graphed, preempted by SIGTERM
    mid-window or on a jump step and resumed by a fresh Trainer: losses
    and final state bit-identical to the uninterrupted graphed run. The
    leaf-wise checkpoint's Grams are K3's rebuild, which rounds
    differently from the carried K1 rows; the restore replays the current
    window's K1 rows. Launches over the two halves: K1 once per record
    plus one per replayed row, K2 once per jump, K3 once per save and
    once for the restore's template."""
    import signal
    steps = 30
    tr, batch = _mlp_trainer(cuda, scope="bucket", mode="eig")
    acc = tr.acc
    j1 = next(t for t in range(steps) if acc.apply_groups(t))
    at = next(t for t in range(j1 + 1, steps)
              if (acc.apply_groups(t) if when == "jump" else
                  acc.should_record(t) and acc.slot(t) >= 1
                  and not acc.apply_groups(t)))
    want = []
    full = tr.fit(iter(lambda: batch, None), steps,
                  on_metrics=lambda t, m: want.append(m["loss"]))
    ka.reset_launches()

    def bomb(t, m):
        if t == at:
            signal.raise_signal(signal.SIGTERM)
    tr_b, _ = _mlp_trainer(cuda, scope="bucket", mode="eig")
    tr_b.checkpoint_dir = str(tmp_path)
    try:
        st_b = tr_b.fit(iter(lambda: batch, None), steps, on_metrics=bomb)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert int(st_b.step) == at + 1
    tr_c, _ = _mlp_trainer(cuda, scope="bucket", mode="eig")
    tr_c.checkpoint_dir = str(tmp_path)
    got = []
    st_c = tr_c.fit(iter(lambda: batch, None), steps,
                    on_metrics=lambda t, m: got.append(m["loss"]))
    torch.cuda.synchronize()
    assert tr_c.graph_stats["captured"] >= 1
    assert torch.equal(torch.stack(got), torch.stack(want[at + 1:]))
    a, b = _state_tensors(full), _state_tensors(st_c)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    n_rec = sum(acc.should_record(t) for t in range(steps))
    n_jump = sum(acc.should_apply(t) for t in range(steps))
    replayed = 0 if when == "jump" else acc.slot(at) + 1
    assert ka.LAUNCHES == {"gram_row": n_rec + replayed, "gram": 2,
                           "combine": n_jump}
    _assert_tickets_zero(cuda)


def test_host_eig_never_runs_inside_a_capture(cuda):
    """Eig mode's host step reads the device, which a CUDA graph capture
    forbids: called under a capture it raises (no silent fallback). A
    graphed eig-mode fit captures its non-jump steps and runs every jump
    eagerly: one host eig per jump, none per capture or replay."""
    from repro_torch.core import dmd
    a = torch.eye(4, device=cuda).expand(2, 4, 4).contiguous()
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="capture"):
        with torch.cuda.graph(graph, stream=side):
            dmd._eig_power(a, 5, False, 5)
    torch.cuda.synchronize()
    tr, batch = _mlp_trainer(cuda, mode="eig", scope="bucket")
    dmd.reset_eig_stats()
    tr.fit(iter(lambda: batch, None), 30)
    n_jump = sum(tr.acc.should_apply(t) for t in range(30))
    assert tr.graph_stats["captured"] >= 2
    assert tr.graph_stats["replayed"] > 0
    assert tr.graph_stats["emptied"] == 0         # room to spare: cache kept
    st = dmd.eig_stats()
    assert (st["calls"], st["systems"]) == (n_jump, n_jump)


# ---------------------------------------------------------------------------
# The launcher's recompute route and the paper benches' shapes
# ---------------------------------------------------------------------------

def _all_launches():
    return {**ka.LAUNCHES, **kgr.LAUNCHES, **kc.LAUNCHES, **kg.LAUNCHES}


@pytest.mark.parametrize("arena", [True, False])
def test_recompute_route_on_card(cuda, arena):
    """``streaming_gram=False``, the launcher's and the benches' route: a
    record launches nothing, each jump recomputes the Gram (K3 on the
    arena, K6 per leaf) and combines (K2, K5); with the benches' ``guard=
    False`` every jump is kept. Losses within rtol 2e-3 of the CPU run's
    (the paper-loop parity bound)."""
    X, Y = synthetic_regression(seed=0, n=64, n_out=130)
    cfg = DMDConfig(m=4, s=5, warmup_steps=5, cooldown_steps=2,
                    arena_block_n=128, arena=arena, streaming_gram=False)
    params = init_mlp(torch.Generator().manual_seed(0), (6, 16, 40, 130),
                      device="cpu")
    runs = {}
    for guard in (True, False):
        before = _all_launches()
        on_card = paper_loop.train(X, Y, (6, 16, 40, 130), cfg, 30,
                                   params=params, guard=guard,
                                   device=cuda)
        after = _all_launches()
        on_cpu = paper_loop.train(X, Y, (6, 16, 40, 130), cfg, 30,
                                  params=params, guard=guard,
                                  device="cpu")
        want = ({"gram": 4, "combine": 4} if arena
                else {"flat_gram": 4 * 6, "flat_combine": 4 * 6})
        assert {k: after[k] - before[k] for k in after} == \
            {k: want.get(k, 0) for k in after}
        assert on_card.grams is None and len(on_card.jumps) == 4
        assert on_card.reverted == on_cpu.reverted
        np.testing.assert_allclose(on_card.losses, on_cpu.losses, rtol=2e-3)
        runs[guard] = on_card
    assert runs[False].reverted == []
    _assert_tickets_zero(cuda)


def _bench_buckets(device):
    """The arena buckets the paper benches' DMD runs jump: fig3's and the
    controller's MLP, fig4's, and staggered_jump's synchronous and
    three-group tables."""
    from repro_torch.benchmarks import paper_benches as pb
    cfg = DMDConfig(m=14, s=55, tol=1e-4, warmup_steps=100,
                    cooldown_steps=10)
    gen = torch.Generator().manual_seed(0)
    out = []
    for sizes, c in (((6, 40, 100, 400), cfg), ((6, 40, 200, 400), cfg),
                     ((6, 800, 800, 800), pb.staggered_config(14))):
        params = init_mlp(gen, sizes, device=device)
        out += list(DMDAccelerator(c, device=device).arena_for(
            params).values())
    return out


def test_arena_kernels_match_twins_at_the_bench_arenas(cuda):
    """K1 (anchored, the query a slot), K3 (anchored and not) and K2 on
    random data laid out as each bench arena: within 1e-5 of each twin's
    largest entry."""
    buckets = _bench_buckets(cuda)
    assert len(buckets) == 5
    g = torch.Generator(device=cuda).manual_seed(7)
    for b in buckets:
        seg = b.tables_on(cuda)
        x = torch.randn((b.n_blocks, b.m, b.block_n), generator=g,
                        device=cuda)
        c = torch.randn((seg.n_sys, b.m), generator=g, device=cuda)
        q = x[:, b.m - 1, :]
        _compare(ka.gram_row(x, q, seg, anchor_first=True),
                 ka.gram_row_ref(x, q, seg.block_sys, seg.n_sys,
                                 anchor_first=True), False)
        for anchor_first in (False, True):
            _compare(ka.gram(x, seg, anchor_first=anchor_first),
                     ka.gram_ref(x, seg.block_sys, seg.n_sys,
                                 anchor_first=anchor_first), False)
        _compare(ka.combine(x, c, seg), ka.combine_ref(x, c, seg.block_sys),
                 False)
    _assert_tickets_zero(cuda)


def test_flat_kernels_match_twins_at_the_streaming_leaf(cuda):
    """K4-K6 on streaming_gram's (14, 1, 4000000) leaf: within 1e-5 of the
    twin's largest entry, anchored and not; bit-identical on integer
    data."""
    m, n = 14, 4_000_000
    g = torch.Generator(device=cuda).manual_seed(8)
    for integer in (False, True):
        x = (torch.randint(-1, 2, (m, 1, n), generator=g, device=cuda)
             .float() if integer else
             torch.randn((m, 1, n), generator=g, device=cuda))
        c = torch.randn((1, m), generator=g, device=cuda)
        if integer:
            c = c.round()
        for anchor_first in (False, True):
            _compare(kgr.gram_row(x, x[m - 1], anchor_first=anchor_first),
                     kgr.gram_row_ref(x, x[m - 1],
                                      anchor_first=anchor_first), integer)
            _compare(kg.gram(x, anchor_first=anchor_first),
                     kg.gram_ref(x, anchor_first=anchor_first), integer)
        _compare(kc.combine(x, c), kc.combine_ref(x, c), integer)
    _assert_tickets_zero(cuda)


def test_bench_suites_launch_counts_on_card(cuda):
    """streaming_gram and sec3_overhead at small arguments on the card:
    K4 once per fill record and per timed streaming record, K5 once per
    apply, K6 once per recompute apply; sec3's K3 and K2 once per timed
    jump and its warm-up, no K1."""
    from repro_torch.benchmarks import paper_benches as pb
    before = _all_launches()
    rows = pb.streaming_gram(m=4, n=4096, reps=2, device=cuda)
    after = _all_launches()
    want = {"flat_gram_row": 4 + 1 + 2, "flat_combine": 2 * 3,
            "flat_gram": 3}
    assert {k: after[k] - before[k] for k in after} == \
        {k: want.get(k, 0) for k in after}
    assert rows[-1] == "streaming,m,4,n,4096"
    before = _all_launches()
    rows = pb.sec3_overhead(m=4, t_samples=16, device=cuda)
    after = _all_launches()
    assert {k: after[k] - before[k] for k in after} == \
        {k: {"gram": 11, "combine": 11}.get(k, 0) for k in after}
    assert rows[0] == "sec3,analytic_dmd_ops_per_round,1.643e+08"


def test_dmd_solve_on_card_is_the_cpu_solve(cuda, monkeypatch):
    """Every Gram fig4's DMD run solves (the port's ``_train`` on the CPU
    at fig4's full size: 20 jumps of 6 systems), solved on the card and on
    the CPU: the same rank in every system (the eigendecomposition of
    X^T X runs on the host's LAPACK for both, and the affine shift is the
    same in-order fp32 sum) and c nearer the CPU's than a 1-ulp scaling of
    the Gram moves the CPU's own c (measured: at most 0.12 of that, on
    NVIDIA H100 80GB HBM3, 700 W). cuSOLVER's eigensolver kept other ranks
    on such Grams, and its unguarded fig4 runs jumped 52-1117x
    (``examples/torch_noise_floor.py --case card``)."""
    from repro_torch.benchmarks import paper_benches as pb
    from repro_torch.core import arena as arena_mod
    solves = []
    solve = arena_mod.dmd_math.dmd_coefficients

    def recorded(gram, **kw):
        solves.append((gram.clone(), kw))
        return solve(gram, **kw)
    monkeypatch.setattr(arena_mod.dmd_math, "dmd_coefficients", recorded)
    X, Y, _, _, Xte, Yte = pb.fig4_split()
    pb._train(DMDConfig(**pb.FIG4_DMD), (6, 40, 200, 400), X, Y, Xte, Yte,
              600, device="cpu")
    monkeypatch.undo()
    assert len(solves) == 20
    eps = np.finfo(np.float32).eps
    for gram, kw in solves:
        c, info = solve(gram, **kw)
        spread = torch.stack([(solve(gram * (1 + k * eps), **kw)[0] - c)
                              .abs().amax(dim=-1) for k in (1, -1, 2, -2)]
                             ).amax(dim=0)
        gc, ginfo = solve(gram.to(cuda), **kw)
        assert torch.equal(ginfo["rank"].cpu(), info["rank"])
        assert ((gc.cpu() - c).abs().amax(dim=-1) <= spread).all()


# K7b (the flash-attention backward) against its twin, autograd through
# flash_attention_ref, on unit-normal q, k, v and dO: (B, S, H, K, d,
# causal, window), Sq = Sk. Held row by row: every row of dq (one query and
# head), dk and dv (one key and kv head) within ||kernel - twin|| <=
# BWD_ROW_TOL * ||twin||, the twin's dq given K7's output as K7b receives
# it (chip_smoke.py's rule, whose phase 15 reads a sound bf16 design and a
# wrong one against the same limit); the log-sum-exp within LSE_ATOL
# absolute
BWD_ROW_TOL = {torch.float32: 2e-4, torch.bfloat16: 1.2e-2}
LSE_ATOL = 1e-4
# a row whose twin's norm is under ROW_FLOOR times the gradient's
# root-mean-square row norm (the first query's dq is 0) is held to that
ROW_FLOOR = 1e-1
# what graphed fits may leave on the card: the capture stream's ticket
# buffer and cuBLAS workspaces (67,109,376 bytes on NVIDIA H100 80GB HBM3)
GRAPH_LEFT_BYTES = 80 * 2 ** 20


def _row_err(got, want):
    diff = (got.float() - want.float()).norm(dim=-1)
    norm = want.float().norm(dim=-1)
    floor = ROW_FLOOR * float(norm.square().mean().sqrt())
    return float((diff / norm.clamp_min(max(floor, 1e-30))).max())


BWD_CASES = (
    [(2, 256, 8, 2, 64, True, 0), (1, 200, 8, 8, 128, True, 0),
     (1, 160, 8, 1, 64, False, 0), (1, 256, 4, 2, 64, True, 48),
     (2, 100, 4, 2, 16, False, 30), (1, 96, 4, 4, 48, True, 0)]
    + [(1, s, 8, 1, d, True, 0) for d in (64, 128)
       for s in (127, 128, 129, 257)])


@pytest.mark.parametrize("case", BWD_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_bwd_matches_twin(cuda, case, dtype):
    B, S, H, K, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(S + d)
    q, k, v, dout = (torch.randn(shape, generator=g, device=cuda).to(dtype)
                     for shape in ((B, S, H, d), (B, S, K, d), (B, S, K, d),
                                   (B, S, H, d)))
    out, lse = kf.flash_attention_lse(q, k, v, causal=causal, window=window)
    want_lse = kf.lse_ref(q, k, causal=causal, window=window)
    assert (lse - want_lse).abs().max() <= LSE_ATOL
    assert torch.equal(out, kf.flash_attention(q, k, v, causal=causal,
                                               window=window))
    n0 = dict(kf.LAUNCHES)
    got = kf.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                 window=window)
    again = kf.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                   window=window)
    assert kf.LAUNCHES["flash_attention_bwd"] == n0["flash_attention_bwd"] + 2
    assert kf.LAUNCHES["flash_attention_bwd_wgmma"] == \
        n0["flash_attention_bwd_wgmma"] + 2 * kf.uses_wgmma(dtype, d)
    want = kf.flash_attention_bwd_ref(q, k, v, dout, causal=causal,
                                      window=window, out=out)
    for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
        assert a.dtype == dtype and a.shape == w.shape, name
        assert torch.equal(a, b), f"{name} not repeatable"
        err = _row_err(a, w)
        assert err <= BWD_ROW_TOL[dtype], f"{name}: {err}"


def test_flash_autograd_runs_k7_and_k7b(cuda):
    """A gradient through flash_attention on the card: one K7 launch with
    the log-sum-exp, one K7b call (both through their Hopper designs), and
    the gradients K7b gives alone."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 130, 8, 64), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((2, 130, 2, 64), generator=g, device=cuda).bfloat16()
            for _ in range(2))
    dout = torch.randn_like(q)
    before = dict(kf.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = kf.flash_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    assert {n: kf.LAUNCHES[n] - before[n] for n in before} == {
        "flash_attention": 1, "flash_attention_wgmma": 1,
        "flash_attention_offset": 0, "flash_attention_bwd": 1,
        "flash_attention_bwd_wgmma": 1, "flash_attention_bwd_offset": 0}
    o2, lse = kf.flash_attention_lse(q, k, v)
    assert torch.equal(out.detach(), o2)
    for a, b in zip(grads, kf.flash_attention_bwd(q, k, v, o2, dout, lse)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128])
def test_flash_bwd_wgmma_reads_strided_views(cuda, d):
    """K7b's Hopper design through its TMA tensor maps: q, k and v as head
    slices of one fused projection and dO as a transposed view of a
    (B, H, S, d) tensor give the same bits as contiguous copies, and hold
    the twin row by row."""
    g = torch.Generator(device="cpu").manual_seed(d)
    qkv = torch.randn((2, 257, 12, d), generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    dout = torch.randn((2, 8, 257, d), generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2)
    out, lse = kf.flash_attention_lse(q, k, v)
    n0 = kf.LAUNCHES["flash_attention_bwd_wgmma"]
    got = kf.flash_attention_bwd(q, k, v, out, dout, lse)
    flat = kf.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                  v.contiguous(), out, dout.contiguous(),
                                  lse)
    assert kf.LAUNCHES["flash_attention_bwd_wgmma"] == n0 + 2
    want = kf.flash_attention_bwd_ref(q, k, v, dout, out=out)
    for name, a, b, w in zip(("dq", "dk", "dv"), got, flat, want):
        assert torch.equal(a, b), name
        err = _row_err(a, w)
        assert err <= BWD_ROW_TOL[torch.bfloat16], f"{name}: {err}"


def _lm_trainer(cuda, graphs):
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.models.transformer import LanguageModel
    from repro_torch.train import Trainer
    acfg = get_config("tinyllama-1.1b")
    mc = reduced(acfg.model, n_layers=2, d_model=128, d_ff=256,
                 vocab_size=512, n_heads=4, n_kv_heads=2, head_dim=64)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=DMDConfig(m=4, s=10, warmup_steps=4, cooldown_steps=2),
        optimizer=dataclasses.replace(acfg.optimizer, warmup_steps=4,
                                      total_steps=24),
        train=TrainConfig(global_batch=4, seq_len=128))
    assert acfg.parallel.grad_accum == 4 and acfg.parallel.remat == "block"
    model = LanguageModel(mc, chunk_k=128, remat="block", device=cuda)
    return Trainer(model, acfg, device=cuda, cuda_graphs=graphs)


def test_lm_trainer_graphed_fit_matches_eager(cuda):
    """The reduced TinyLlama (bf16, d 128, heads of 64: K7's Hopper
    design) through the Trainer with its config's grad_accum 4, remat,
    adamw with clip and the cosine schedule: the graphed run's losses and
    final params equal the eager run's bit for bit, with K7 twice and K7b
    once per layer and microbatch, K1 per bucket per record and K2 per
    bucket per jump."""
    from repro_torch.data.tokens import synthetic_lm_batches
    runs = {}
    for graphs in (True, False):
        tr = _lm_trainer(cuda, graphs)
        losses = []
        for c in (ka.LAUNCHES, kf.LAUNCHES):
            for key in c:
                c[key] = 0
        st = tr.fit(synthetic_lm_batches(0, 4, 128, 512, device=cuda), 22,
                    state=tr.init_state(key=torch.Generator(
                        device=cuda).manual_seed(0)),
                    on_metrics=lambda t, m: losses.append(float(m["loss"])))
        torch.cuda.synchronize()
        n_buckets = len(tr.acc.arena_for(st.params))
        assert n_buckets == 2                        # bf16 and fp32 norms
        assert kf.LAUNCHES["flash_attention"] == 2 * 2 * 4 * 22
        assert kf.LAUNCHES["flash_attention_bwd"] == 2 * 4 * 22
        assert kf.LAUNCHES["flash_attention_bwd_wgmma"] == \
            kf.LAUNCHES["flash_attention_bwd"]
        assert kf.LAUNCHES["flash_attention_wgmma"] == \
            kf.LAUNCHES["flash_attention"]
        assert ka.LAUNCHES["gram_row"] == n_buckets * 12     # 3 windows
        assert ka.LAUNCHES["combine"] == n_buckets * 3       # 9, 15, 21
        runs[graphs] = (losses, st, dict(tr.graph_stats))
    (lg, sg, stats), (le, se, _) = runs[True], runs[False]
    assert stats["replayed"] > 0
    assert lg == le and np.isfinite(lg).all()
    for (path, a), (_, b) in zip(leaves_with_paths(sg.params),
                                 leaves_with_paths(se.params)):
        assert torch.equal(a, b), path


def test_lm_trainer_fit_releases_its_graphs(cuda, monkeypatch):
    """A graphed fit's CUDA graphs, their shared pool and the state leave
    the card with their last reference, without the garbage collector:
    the graphs' owner is gone when fit returns, and once the state is
    dropped the card holds what it held before, but for what the capture
    stream keeps (its cuBLAS workspaces and the kernels' ticket buffer),
    made by the first fit and reused by the second."""
    import gc
    import weakref
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.train import loop
    made = []

    class Recorded(loop._GraphedSteps):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(weakref.ref(self))
    monkeypatch.setattr(loop, "_GraphedSteps", Recorded)
    tr = _lm_trainer(cuda, True)
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    left, alive = [], []
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        for _ in range(2):
            st = tr.fit(synthetic_lm_batches(0, 4, 128, 512, device=cuda),
                        12, state=tr.init_state(key=torch.Generator(
                            device=cuda).manual_seed(0)))
            torch.cuda.synchronize()
            alive.append([r() is not None for r in made])
            del st
            left.append(torch.cuda.memory_allocated(cuda) - base)
    finally:
        if enabled:
            gc.enable()
    assert tr.graph_stats["captured"] > 0
    assert alive == [[False], [False, False]]
    assert left[1] == left[0] <= GRAPH_LEFT_BYTES, left


# -- the MoE family ------------------------------------------------------------

def _moe_layer_run(p, x, dout, cfg):
    from repro_torch.core.paths import map_with_paths
    from repro_torch.models import moe
    req = {path: t.detach().clone().requires_grad_(True)
           for path, t in leaves_with_paths(p)}
    xr = x.detach().clone().requires_grad_(True)
    out, aux = moe.apply_moe(xr, map_with_paths(lambda path, _: req[path],
                                                p), cfg)
    ((out.float() * dout).sum() + aux).backward()
    _, top_i, _, routing = moe.route(x, p, cfg)
    grads = {"x": xr.grad, **{path: t.grad for path, t in req.items()}}
    return out.detach(), aux.detach(), grads, top_i, routing.sel_idx


@pytest.mark.parametrize("top_k,shared", [(8, 0), (1, 1)])
def test_moe_layer_on_card_matches_cpu_and_repeats(cuda, top_k, shared):
    """One bf16 MoE layer (128 experts, Qwen3's top-8 and Llama4's top-1
    with a shared expert, d 256) forward and backward on the card: two
    runs bit-identical (the ordered scatter-add, no float atomics); the
    same routing as the CPU from the same params (integer-valued router
    inputs keep the fp32 logits exact in any order, so no near-ties
    split the two), output, aux and gradients within 3e-2 of the CPU
    tensor's largest magnitude (bf16 expert products in two summation
    orders)."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    from repro_torch.models import moe
    cfg = ModelConfig(d_model=256, dtype="bfloat16", moe=MoEConfig(
        n_experts=128, top_k=top_k, expert_d_ff=128,
        n_shared_experts=shared, shared_d_ff=64 if shared else 0))
    g = torch.Generator(device=cuda).manual_seed(3)
    p = moe.moe_init(g, cfg, cuda)
    p["router"] = torch.randint(-3, 4, p["router"].shape, generator=g,
                                device=cuda).float() / 64
    x = torch.randint(-4, 5, (2, 96, 256), generator=g,
                      device=cuda).to(torch.bfloat16)
    dout = torch.randn(x.shape, generator=g, device=cuda)
    a, b = _moe_layer_run(p, x, dout, cfg), _moe_layer_run(p, x, dout, cfg)
    for u, v in zip(a[:2] + a[3:], b[:2] + b[3:]):
        assert torch.equal(u, v)
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name
    from repro_torch.core.paths import tree_map
    c = _moe_layer_run(tree_map(lambda t: t.cpu(), p), x.cpu(), dout.cpu(),
                       cfg)
    assert torch.equal(a[3].cpu(), c[3]) and torch.equal(a[4].cpu(), c[4])
    pairs = [("out", a[0], c[0]), ("aux", a[1], c[1])] + [
        (f"d{n}", a[2][n], c[2][n]) for n in c[2]]
    for name, got, want in pairs:
        got, want = got.cpu().float(), want.float()
        err = float((got - want).abs().max())
        assert err <= 3e-2 * float(want.abs().max()), (name, err)


def _moe_trainer(cuda, graphs):
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import OptimizerConfig, TrainConfig
    from repro_torch.models.transformer import LanguageModel
    from repro_torch.train import Trainer
    acfg = get_config("qwen3-moe-30b-a3b")
    mc = reduced(acfg.model, n_layers=2, d_model=128, vocab_size=512,
                 n_heads=4, n_kv_heads=2, head_dim=128)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, m=4, s=10, warmup_steps=4,
                                cooldown_steps=2),
        optimizer=dataclasses.replace(acfg.optimizer, warmup_steps=4,
                                      total_steps=24),
        train=TrainConfig(global_batch=4, seq_len=128))
    assert acfg.parallel.grad_accum == 4 and acfg.parallel.remat == "block"
    assert acfg.dmd.snapshot_dtype == "bfloat16"
    model = LanguageModel(mc, chunk_k=128, remat="block", device=cuda)
    return Trainer(model, acfg, device=cuda, cuda_graphs=graphs)


def test_moe_trainer_graphed_fit_matches_eager(cuda):
    """The reduced Qwen3 MoE LM (bf16, heads of 128: K7's and K7b's Hopper
    designs; the config's bf16 ring with every param, grad_accum 4, remat,
    adamw) through the Trainer: the graphed run's losses and final params
    equal the eager run's bit for bit, with K7 twice and K7b once per
    layer and microbatch, K1 per bucket per record, K2 per bucket per
    jump."""
    from repro_torch.data.tokens import synthetic_lm_batches
    runs = {}
    for graphs in (True, False):
        tr = _moe_trainer(cuda, graphs)
        losses = []
        for c in (ka.LAUNCHES, kf.LAUNCHES):
            for key in c:
                c[key] = 0
        st = tr.fit(synthetic_lm_batches(0, 4, 128, 512, device=cuda), 22,
                    state=tr.init_state(key=torch.Generator(
                        device=cuda).manual_seed(0)),
                    on_metrics=lambda t, m: losses.append(float(m["loss"])))
        torch.cuda.synchronize()
        n_buckets = len(tr.acc.arena_for(st.params))
        assert n_buckets == 2                # bf16 and fp32 (router, norms)
        assert kf.LAUNCHES["flash_attention"] == \
            kf.LAUNCHES["flash_attention_wgmma"] == 2 * 2 * 4 * 22
        assert kf.LAUNCHES["flash_attention_bwd"] == \
            kf.LAUNCHES["flash_attention_bwd_wgmma"] == 2 * 4 * 22
        assert ka.LAUNCHES["gram_row"] == n_buckets * 12     # 3 windows
        assert ka.LAUNCHES["combine"] == n_buckets * 3       # 9, 15, 21
        runs[graphs] = (losses, st, dict(tr.graph_stats))
    (lg, sg, stats), (le, se, _) = runs[True], runs[False]
    assert stats["replayed"] > 0
    assert lg == le and np.isfinite(lg).all()
    for (path, a), (_, b) in zip(leaves_with_paths(sg.params),
                                 leaves_with_paths(se.params)):
        assert torch.equal(a, b), path


# -- the SSM and hybrid families -------------------------------------------

def _ssm_block_run(kind, p, shared, x, dout, cfg, n_pre):
    """One super-block forward and backward, then the first `n_pre`
    tokens' prefill into a fresh state and the next token's decode:
    (out, {path: gradient}, prefill out, decode out)."""
    from repro_torch.core.paths import map_with_paths
    from repro_torch.models import ssm, transformer
    from repro_torch.models.attention import init_kv_cache
    tree = {"p": p, "shared": shared}
    req = {path: t.detach().clone().requires_grad_(True)
           for path, t in leaves_with_paths(tree)}
    live = map_with_paths(lambda path, _: req[path], tree)
    xr = x.detach().clone().requires_grad_(True)
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None].expand(B, S)
    out, _, _ = transformer._apply_block(
        kind, xr, live["p"], cfg, positions=pos, cache=None, chunk_k=64,
        shared=live["shared"])
    (out.float() * dout).sum().backward()
    grads = {"x": xr.grad, **{path: t.grad for path, t in req.items()}}
    state = ssm.init_ssm_state(B, cfg, x.dtype, x.device,
                               () if kind == "mamba"
                               else (cfg.shared_attn_every,))
    cache = state if kind == "mamba" else {
        "mamba": state, "shared": init_kv_cache(
            B, S, cfg.n_kv_heads, cfg.head_dim, x.dtype, x.device)}
    with torch.no_grad():
        pre, cache, _ = transformer._apply_block(
            kind, x[:, :n_pre], p, cfg, positions=pos[:, :n_pre],
            cache=cache, chunk_k=64, shared=shared)
        dec, _, _ = transformer._apply_block(
            kind, x[:, n_pre:n_pre + 1], p, cfg,
            positions=pos[:, n_pre:n_pre + 1], cache=cache, chunk_k=64,
            shared=shared)
    return out.detach(), grads, pre, dec


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_block_on_card_matches_cpu_and_repeats(cuda, arch):
    """One fp32 Mamba-2 block (and a zamba super-block: 6 of them and the
    shared attention + MLP, heads of 80 on K7's and K7b's fp32 kernels) at
    d 512 on 256 tokens (4 SSD chunks of 64): forward, backward, a
    128-token prefill and one decode step twice on the card (bit-identical:
    no float atomics on this path) and on the CPU from the same params,
    within 1e-3 of the CPU tensor's largest magnitude (IEEE fp32 products
    summed in other orders; the fp32 scalars' gradients sum over every
    token with cancellation, which bf16 rounding would swamp)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.paths import tree_map
    from repro_torch.models import ssm, transformer
    base = get_config(arch).model
    cfg = reduced(base, d_model=512, n_heads=8, n_kv_heads=8, head_dim=80,
                  d_ff=1024, ssm=dataclasses.replace(base.ssm, chunk=64),
                  dtype="float32")
    kind = "mamba" if cfg.family == "ssm" else "zamba"
    g = torch.Generator(device=cuda).manual_seed(5)

    def mamba():
        p = {"ln": {"scale": 0.1 * torch.randn((cfg.d_model,), generator=g,
                                               device=cuda)},
             "ssm": ssm.ssm_init(g, cfg, cuda)}
        for k in ("A_log", "dt_bias", "skip_d", "norm_scale"):
            p["ssm"][k] = 0.5 * torch.randn(p["ssm"][k].shape, generator=g,
                                            device=cuda)
        return p
    p, shared = ((mamba(), None) if kind == "mamba" else
                 ({"mamba": [mamba() for _ in range(6)]},
                  transformer._block_init(g, cfg, "dense", (), cuda)))
    x = torch.randn((2, 256, cfg.d_model), generator=g, device=cuda)
    dout = torch.randn(x.shape, generator=g, device=cuda)
    kf.LAUNCHES["flash_attention"] = kf.LAUNCHES["flash_attention_bwd"] = 0
    a = _ssm_block_run(kind, p, shared, x, dout, cfg, 128)
    if kind == "zamba":                   # forward, prefill; one backward
        assert kf.LAUNCHES["flash_attention"] == 2
        assert kf.LAUNCHES["flash_attention_bwd"] == 1
    b = _ssm_block_run(kind, p, shared, x, dout, cfg, 128)
    for i in (0, 2, 3):
        assert torch.equal(a[i], b[i])
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name
    host = lambda t: t.cpu()  # noqa: E731
    c = _ssm_block_run(kind, tree_map(host, p),
                       None if shared is None else tree_map(host, shared),
                       x.cpu(), dout.cpu(), cfg, 128)
    pairs = [("out", a[0], c[0]), ("prefill", a[2], c[2]),
             ("decode", a[3], c[3]), ("decode vs forward", a[3],
                                      a[0][:, 128:129])]
    pairs += [(f"d{n}", a[1][n], c[1][n]) for n in c[1]]
    for name, got, want in pairs:
        got, want = got.cpu(), want.cpu()
        err = float((got - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), (name, err)


def test_k1_on_a_long_bf16_ring_within_twice_the_chunked_twin(cuda):
    """K1 on a bf16 ring of 2^20 blocks x 14 x 512 in 4 systems (262k
    blocks each) of snapshot-like rows (x_j = w + j d: the anchored
    products share a sign, as on a training ring): its distance from a
    float64 twin is at most twice the chunked fp32 twin's (one running
    sum a thread over its whole block range read 14-46x the twin's on
    such rings)."""
    nb, m, n_sys, chunk = 1 << 20, 14, 4, 1 << 16
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.empty((nb, m, 512), dtype=torch.bfloat16, device=cuda)
    j = torch.arange(m, device=cuda, dtype=torch.float32)[:, None]
    for a in range(0, nb, chunk):
        w = 0.02 * torch.randn((chunk, 1, 512), generator=g, device=cuda)
        d = 1e-3 * torch.randn((chunk, 1, 512), generator=g, device=cuda)
        x[a:a + chunk] = (w + j * d).to(torch.bfloat16)
    seg = ka.Segments.from_block_sys(np.repeat(np.arange(n_sys), nb // n_sys),
                                     n_sys, cuda)
    q = x[:, m - 1, :]
    exact = torch.zeros((n_sys, m), dtype=torch.float64, device=cuda)
    twin = torch.zeros((n_sys, m), dtype=torch.float32, device=cuda)
    idx = seg.block_sys.long()
    for a in range(0, nb, chunk):
        xs, qs = x[a:a + chunk].double(), q[a:a + chunk].double()
        qs, xs = qs - xs[:, 0, :], xs - xs[:, 0:1, :]
        exact.index_add_(0, idx[a:a + chunk],
                         torch.bmm(xs, qs.unsqueeze(-1)).squeeze(-1))
        twin += ka.gram_row_ref(x[a:a + chunk], q[a:a + chunk],
                                seg.block_sys[a:a + chunk], n_sys,
                                anchor_first=True)
    got = ka.gram_row(x, q, seg, anchor_first=True)
    assert torch.equal(got, ka.gram_row(x, q, seg, anchor_first=True))
    err = float((got.double() - exact).abs().max())
    t_err = float((twin.double() - exact).abs().max())
    assert err <= 2.0 * t_err, (err, t_err)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_ssm_trainer_graphed_fit_matches_eager(cuda, arch):
    """Reduced Mamba2 (3 layers) and Zamba2 (8: a group of 6 and a
    2-layer remainder; the shared attention's heads of 16 on K7's and
    K7b's sm_80-unit designs) with the config's bf16 ring on every param,
    grad_accum 8 and remat through the Trainer: the graphed run's losses
    and final params equal the eager run's bit for bit, with K1 per bucket
    per record, K2 per bucket per jump, and for zamba K7 twice and K7b
    once per group and microbatch."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.tokens import synthetic_lm_batches
    from repro_torch.models.transformer import LanguageModel
    from repro_torch.train import Trainer
    acfg = get_config(arch)
    mc = reduced(acfg.model, n_layers=3 if arch.startswith("mamba") else 8)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, m=4, s=10, warmup_steps=4,
                                cooldown_steps=2),
        optimizer=dataclasses.replace(acfg.optimizer, warmup_steps=4,
                                      total_steps=24),
        train=TrainConfig(global_batch=8, seq_len=64))
    assert acfg.parallel.grad_accum == 8 and acfg.parallel.remat == "block"
    groups = mc.n_layers // 6 if arch.startswith("zamba") else 0
    runs = {}
    for graphs in (True, False):
        tr = Trainer(LanguageModel(mc, chunk_k=64, remat="block",
                                   device=cuda), acfg, device=cuda,
                     cuda_graphs=graphs)
        losses = []
        for c in (ka.LAUNCHES, kf.LAUNCHES):
            for key in c:
                c[key] = 0
        st = tr.fit(synthetic_lm_batches(0, 8, 64, mc.vocab_size,
                                         device=cuda), 22,
                    state=tr.init_state(key=torch.Generator(
                        device=cuda).manual_seed(0)),
                    on_metrics=lambda t, m: losses.append(float(m["loss"])))
        torch.cuda.synchronize()
        n_buckets = len(tr.acc.arena_for(st.params))
        assert n_buckets == 2                # bf16 and the fp32 scalars
        assert kf.LAUNCHES["flash_attention"] == 2 * groups * 8 * 22
        assert kf.LAUNCHES["flash_attention_bwd"] == groups * 8 * 22
        assert ka.LAUNCHES["gram_row"] == n_buckets * 12     # 3 windows
        assert ka.LAUNCHES["combine"] == n_buckets * 3       # 9, 15, 21
        runs[graphs] = (losses, st, dict(tr.graph_stats))
    (lg, sg, stats), (le, se, _) = runs[True], runs[False]
    assert stats["replayed"] > 0
    assert lg == le and np.isfinite(lg).all()
    for (path, a), (_, b) in zip(leaves_with_paths(sg.params),
                                 leaves_with_paths(se.params)):
        assert torch.equal(a, b), path


def test_audit_on_the_card_matches_the_cpu_and_never_syncs(cuda):
    """chip_smoke.py phase 20 (a) and (b): the paper MLP's audit at full
    width is clean on the card, each audited step records as many ops as
    on the CPU and launches its kernel once (K1 in train_step and
    record_update, K2 in both jumps); the plain train step, a record step
    and record_update run under sync-debug "error"."""
    from repro_torch.audit import targets as audit_targets
    from repro_torch.audit.registry import run_passes
    from repro_torch.train.step import audit_step_fns

    ctx = audit_targets.build_context("pollutant-mlp", device=cuda)
    report = run_passes(ctx)
    assert report.ok and len(report.results) == 10, report.render()
    cpu = audit_targets.build_context("pollutant-mlp", device="cpu")
    want = {"train_step": {"gram_row": 1}, "dmd_step": {"combine": 1},
            "dmd_step_gated": {"combine": 1},
            "record_update": {"gram_row": 1}}
    for name, kernels in want.items():
        card, host = ctx.targets[name].recording, cpu.targets[name].recording
        assert card.count == host.count, name
        assert card.launches == kernels, name

    model, acfg, batch = audit_targets._build_model_and_config(
        "pollutant-mlp", False, cuda)
    acc, fns = audit_step_fns(model, acfg, device=cuda)
    state = audit_targets._init_state(model, acfg, acc, cuda)
    slots = audit_targets.audit_slots(acc)
    calls = (lambda: fns["train_step"](state, batch,
                                       np.full((acc.n_groups,), -1)),
             lambda: fns["train_step"](state, batch, slots),
             lambda: fns["record_update"](state.dmd_buffers, state.dmd_gram,
                                          state.params, slots))
    for call in calls:
        call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_sharded_kernels_on_two_ranks_sharing_the_card(cuda, tmp_path):
    """The mesh's data passes on the card: two ranks on the one card
    (gloo on CUDA tensors, a (1, 2) mesh), the lane-sharded arena of the
    small LM and the reference test's system-sharded bucket, both routes:
    K1 / K4 and K3 / K6 per block plus one all-reduce equal one rank's
    kernels (bit for bit on integer data, 1e-5 relative otherwise), K2 /
    K5 per block equal the one-rank kernel's block bit for bit, and a
    record makes all-reduces only. The library is built before the ranks
    start, so that they do not race on its build directory."""
    import torch_mesh_worker as W
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_ranks

    _build.build()
    for r in run_ranks(W.card_kernel_checks, 2, join_timeout=300,
                       tmp_dir=str(tmp_path)):
        for (case, arena, dyadic), v in r.items():
            what = f"{case} {'arena' if arena else 'perleaf'} {dyadic}"
            assert v["k2"] and v["allreduce_only"], what
            if dyadic:
                assert v["exact"], what
            assert v["err"] <= 1e-5, what
