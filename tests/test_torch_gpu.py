"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``gpu``; every test takes the ``cuda`` fixture, which skips (with a
reason) where there is no CUDA device, so every process collects the same
tests. Run on a card with:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: integer-valued data must match exactly (every fp32 sum is
exact in any order); random data |diff| <= 1e-5 * max(1, max|twin|) (fp32
summation order over up to a few thousand lanes per block); two launches
on the same inputs must be bit-identical (no atomics).
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import DMDConfig
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.kernels import arena as ka
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
