"""The port's CUDA kernels (the arena kernels K1-K3, the flat per-leaf
kernels K4-K6 and flash attention K7) against their plain PyTorch twins,
on the card.

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
import numpy as np
import pytest
import torch

from repro_torch.configs.base import DMDConfig
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
    with pytest.raises(ValueError, match="gradient"):
        kf.flash_attention(q.requires_grad_(), q, q)
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
        "flash_attention": 2, "flash_attention_wgmma": 2}
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
