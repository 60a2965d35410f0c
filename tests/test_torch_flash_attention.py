"""The port's flash-attention twin (kernel K7's plain version, the CPU
route of ``kernels/flash_attention.py``) against the reference's Pallas
kernel run in interpret mode, on the same numpy inputs.

Tolerances, on unit-normal inputs, over the rows that see at least one key
(a row that sees none is outside the contract: the Pallas result there
depends on its tiling): fp32 within 2e-5 absolute (one softmax per row
against the online softmax over 64-key tiles); bf16 within 2e-2 absolute
(both compute in fp32 from the same bf16 inputs and round the output to
bf16 once: one bf16 step, 2^-7 relative, at |out| < 2).

The key offset (kv-SP: a rank's keys start at position ``k_offset``) is
held to the reference's jnp core with ``k_positions = arange(Sk) +
k_offset``, and the merge of the twins over 2 and 3 blocks of the keys to
its attention over all of them and to ``jax.grad`` of it, fp32 within
1e-5; the port's contract for a row that sees no key (out 0, log-sum-exp
-1e30, dq 0) is pinned.
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
                           "flash_attention_offset": 0,
                           "flash_attention_bwd": 1,
                           "flash_attention_bwd_wgmma": int(wgmma),
                           "flash_attention_bwd_offset": 0}
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
                           "flash_attention_offset", "flash_attention_bwd",
                           "flash_attention_bwd_wgmma",
                           "flash_attention_bwd_offset"}


# -- the key offset (kv-SP's blocks of the keys) ------------------------------

OFFSET_CASES = [                     # (B, Sq, Sk, H, K, d, causal, window)
    (2, 48, 20, 4, 2, 32, True, 0),
    (1, 40, 24, 4, 1, 16, True, 12),
    (1, 33, 17, 2, 2, 64, False, 0),
]


def _ref_at_offset(q, k, v, causal, window, o):
    """The reference's core over keys at positions o ... o + Sk - 1."""
    from repro.models.attention import blockwise_attention

    Sk = k.shape[1]
    return np.asarray(blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, k_positions=jnp.arange(Sk) + o, kv_len=Sk + o,
        chunk_k=16))


@pytest.mark.parametrize("case", OFFSET_CASES)
@pytest.mark.parametrize("where", ["zero", "mid", "past"])
def test_twin_at_a_key_offset_matches_reference(case, where):
    """``flash_attention_ref(..., k_offset=o)`` against the reference's
    ``blockwise_attention`` with ``k_positions = arange(Sk) + o``, fp32
    within 1e-5, at o = 0, mid-sequence and past every query, over the
    rows that see a key; the rows that see none are exactly 0."""
    B, Sq, Sk, H, K, d, causal, window = case
    o = {"zero": 0, "mid": Sq // 2, "past": Sq + 3}[where]
    q, k, v = _inputs(B, Sq, Sk, H, K, d)
    got = kf.flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal, window=window, k_offset=o)
    rows = kf._mask(Sq, Sk, causal, window, "cpu", o).any(dim=1).numpy()
    want = _ref_at_offset(q, k, v, causal, window, o)
    np.testing.assert_allclose(got.numpy()[:, rows], want[:, rows],
                               rtol=0, atol=1e-5)
    assert (got.numpy()[:, ~rows] == 0).all()
    assert rows.any() == (where != "past" or not causal)


def test_rows_that_see_no_key_follow_the_contract():
    """A row that sees no key: out 0, log-sum-exp -1e30 (finite), dq 0,
    through the twins' forward, log-sum-exp, autograd and K7b's formula
    given an lse; here every query sees none (causal, the keys past every
    query) or the first half does (the keys at mid-sequence)."""
    q, k, v, g = (torch.from_numpy(x) for x in
                  _inputs(1, 32, 16, 4, 2, 32) + [RNG.standard_normal(
                      (1, 32, 4, 32), np.float32)])
    for o, blind in ((32, slice(0, 32)), (16, slice(0, 16))):
        out, lse = kf.flash_attention_lse(q, k, v, causal=True, k_offset=o)
        assert (out[:, blind] == 0).all() and (lse[:, :, blind]
                                                == kf.NEG_INF).all()
        assert torch.isfinite(lse).all() and torch.isfinite(out).all()
        for given in (None, lse):
            dq, dk, dv = kf.flash_attention_bwd(q, k, v, out, g, given,
                                                causal=True, k_offset=o)
            assert (dq[:, blind] == 0).all()
            assert all(torch.isfinite(t).all() for t in (dq, dk, dv))
        if o == 32:
            assert (dk == 0).all() and (dv == 0).all()


def _merged(q, k, v, causal, window, cuts):
    """The twins' kv-SP over the key blocks cut at `cuts`: each block's
    attention and log-sum-exp at its offset, merged by the log-sum-exps
    (kernels/flash_attention's NEG_INF rows weigh 0), and the gradient of
    <g, out> by K7b's formula on the merged out and lse per block: dq
    summed over the blocks, dk and dv each block's."""
    bounds = list(zip([0] + cuts, cuts + [k.shape[1]]))
    parts = [kf.flash_attention_lse(q, k[:, a:b], v[:, a:b], causal=causal,
                                    window=window, k_offset=a)
             for a, b in bounds]
    lses = torch.stack([lse for _, lse in parts])
    L = torch.logsumexp(lses, dim=0)
    out = sum(o * torch.exp(lse - L).transpose(1, 2)[..., None]
              for o, lse in parts)
    return out, L, bounds


@pytest.mark.parametrize("case", OFFSET_CASES)
@pytest.mark.parametrize("cuts", [[10], [5, 13], [1, 2]])
def test_kv_sp_merge_of_twins_matches_reference(case, cuts):
    """Two and three blocks, odd lengths among them: the merge of the
    blocks' twins equals the reference's attention over all the keys, and
    K7b's formula per block on the merged out and lse (dq summed, dk and
    dv concatenated) equals ``jax.grad`` of <g, reference>; fp32 within
    1e-5 of each output's largest entry. A row that sees no key at all
    (the window past the keys) is 0 here and the reference's mean of V,
    outside its contract: g is 0 there, so that the reference's mean adds
    nothing to its dv."""
    import jax

    from repro.models.attention import blockwise_attention

    B, Sq, Sk, H, K, d, causal, window = case
    q, k, v = _inputs(B, Sq, Sk, H, K, d)
    rows = kf._mask(Sq, Sk, causal, window, "cpu").any(dim=1).numpy()
    g = RNG.standard_normal((B, Sq, H, d), np.float32) * rows[:, None, None]
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    out, L, bounds = _merged(tq, tk, tv, causal, window, cuts)

    def ref(q_, k_, v_):
        return blockwise_attention(q_, k_, v_, causal=causal, window=window,
                                   chunk_k=16)
    want = np.asarray(ref(*map(jnp.asarray, (q, k, v))))
    np.testing.assert_allclose(out.numpy()[:, rows], want[:, rows], rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert (out.numpy()[:, ~rows] == 0).all()
    jg = jax.grad(lambda *a: jnp.sum(ref(*a) * g), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    dq = torch.zeros_like(tq)
    dks, dvs = [], []
    for a, b in bounds:
        gq, gk, gv = kf.flash_attention_bwd(
            tq, tk[:, a:b], tv[:, a:b], out, tg, L.contiguous(),
            causal=causal, window=window, k_offset=a)
        dq += gq
        dks.append(gk)
        dvs.append(gv)
    for got, w in zip((dq, torch.cat(dks, 1), torch.cat(dvs, 1)), jg):
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
