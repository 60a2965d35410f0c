"""The port's flash-attention twin (kernel K7's plain version, the CPU
route of ``kernels/flash_attention.py``) against the reference's Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerances, on unit-normal inputs, over the rows that see at least one key
(a row that sees none is outside the contract: the Pallas result there
depends on its tiling): fp32 within 2e-5 absolute (one softmax per row
against the online softmax over 64-key tiles); bf16 within 2e-2 absolute
(both compute in fp32 from the same bf16 inputs and round the output to
bf16 once: one bf16 step, 2^-7 relative, at |out| < 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as kf
from repro_torch.kernels import ops as tops

RNG = np.random.default_rng(0)


def _inputs(B, Sq, Sk, H, K, d):
    return [RNG.standard_normal(shape, np.float32)
            for shape in ((B, Sq, H, d), (B, Sk, K, d), (B, Sk, K, d))]


# tests/test_kernels.py's flash cases, then d = 16 and GQA rep 8
@pytest.mark.parametrize("B,Sq,Sk,H,K,d,causal,window", [
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 256, 256, 2, 2, 64, True, 64),
    (1, 100, 100, 2, 1, 32, False, 0),
    (1, 64, 192, 2, 2, 128, True, 0),          # Sq != Sk
    (2, 96, 96, 4, 2, 16, True, 0),            # d = 16
    (1, 130, 130, 8, 1, 32, True, 48),         # GQA rep 8, window
    (1, 192, 64, 8, 1, 16, False, 0),          # Sq > Sk, rep 8, d 16
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_interpret(B, Sq, Sk, H, K, d, causal, window,
                                       dtype):
    q, k, v = _inputs(B, Sq, Sk, H, K, d)
    jd = getattr(jnp, dtype)
    want = jops.flash_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                jnp.asarray(v, jd), causal=causal,
                                window=window, tq=64, tk=64, interpret=True)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    n0 = kf.LAUNCHES["flash_attention"]
    got = tops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert kf.LAUNCHES["flash_attention"] == n0       # CPU: the twin
    assert got.dtype == td and got.shape == (B, Sq, H, d)
    rows = kf._mask(Sq, Sk, causal, window, "cpu").any(dim=1).numpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(
        got.float().numpy()[:, rows],
        np.asarray(want.astype(jnp.float32))[:, rows], rtol=0, atol=tol)
    assert torch.isfinite(got.float()).all()        # unseen rows too


def test_mask_follows_the_kernel_contract():
    """Positions count from 0 on both sides (not right-aligned)."""
    m = kf._mask(3, 5, True, 0, "cpu")
    assert m.tolist() == [[True, False, False, False, False],
                          [True, True, False, False, False],
                          [True, True, True, False, False]]
    w = kf._mask(4, 4, True, 2, "cpu")
    assert w.sum(dim=1).tolist() == [1, 2, 2, 2]
    assert kf._mask(2, 3, False, 0, "cpu").all()


def test_refusals():
    q = torch.zeros((1, 8, 4, 64))
    with pytest.raises(ValueError, match="head size"):
        kf.flash_attention(q[..., :40], q[..., :40], q[..., :40])
    with pytest.raises(ValueError, match="multiple"):
        kf.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="dtype"):
        kf.flash_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="must match"):
        kf.flash_attention_bwd(q, q, q, q, q[:, :4], None)
    with pytest.raises(ValueError, match="window"):
        kf.flash_attention(q, q, q, window=-1)
    with pytest.raises(ValueError, match="devices"):
        kf.flash_attention(q, q, q.to("meta"))


@pytest.mark.parametrize("d", kf.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_design_follows_dtype_and_head_size(dtype, d, monkeypatch):
    """bf16 at d = 64 and 128 runs the Hopper (wgmma) designs, every other
    dtype and head size the sm_80-unit kernels; nothing else enters the
    choice. The backward takes the same choice: its Hopper entry point,
    counted under flash_attention_bwd_wgmma too, with the padded per-row
    scratch (the launch recorded, not run)."""
    wgmma = dtype == torch.bfloat16 and d in (64, 128)
    assert kf.uses_wgmma(dtype, d) == wgmma
    calls = []
    monkeypatch.setattr(kf, "on_cuda", lambda *ts: True)
    monkeypatch.setattr(kf, "stream", lambda: None)
    monkeypatch.setattr(kf, "launch", lambda name, *a: calls.append(name))
    monkeypatch.setattr(kf, "LAUNCHES", dict.fromkeys(kf.LAUNCHES, 0))
    q = torch.zeros((1, 130, 4, d), dtype=dtype)
    k = torch.zeros((1, 130, 2, d), dtype=dtype)
    kf.flash_attention_bwd(q, k, k, q, q, torch.zeros((1, 4, 130)))
    assert calls == ["flash_attention_bwd_wgmma" if wgmma
                     else "flash_attention_bwd"]
    assert kf.LAUNCHES == {"flash_attention": 0, "flash_attention_wgmma": 0,
                           "flash_attention_bwd": 1,
                           "flash_attention_bwd_wgmma": int(wgmma)}
    assert kf._bwd_rows_shape(1, 4, 130, wgmma) == (
        (1, 4, 2, 256) if wgmma else (1, 4, 130))


def test_cpu_calls_count_no_launch_of_either_design():
    q = torch.zeros((1, 8, 4, 64), dtype=torch.bfloat16)
    before = dict(kf.LAUNCHES)
    kf.flash_attention(q, q, q)
    qg = q.float().requires_grad_()
    kf.flash_attention(qg, qg, qg).sum().backward()
    kf.flash_attention_bwd(q, q, q, q, q, None)
    assert kf.LAUNCHES == before
    assert set(before) == {"flash_attention", "flash_attention_wgmma",
                           "flash_attention_bwd", "flash_attention_bwd_wgmma"}
