"""The port's SSM and hybrid families (``models/ssm.py``, the ``mamba`` /
``zamba`` segments of ``models/transformer.py``, ``configs/{mamba2_2_7b,
zamba2_2_7b}.py``) against the reference on the CPU.

  * ``_causal_conv`` with and without a state, ``ssd_chunked`` (S below
    the chunk, a multiple of it, with a carried h0, two groups) and the
    O(1) decode of ``apply_ssm`` against the reference's functions on the
    same numpy draws, and ``ssd_chunked`` against the reference test's
    per-step recurrence.
  * Reduced Mamba2 (3 layers) and Zamba2 (8 layers: one group of 6 and a
    2-layer Mamba remainder): the param tree, ``param_stack_dims``,
    ``forward`` / ``loss`` / ``prefill`` / ``decode_step`` and every
    gradient (the shared block's summed over its invocations) against the
    reference's, on the reference's own weights carried by
    ``params_from_jax``; remat bit-identical; decode tracking the full
    forward (the reference's ``tests/test_ssm.py`` check).
  * The full-size meta-device init against the reference's abstract
    init: every leaf's shape and dtype and the counts.

Tolerances: the layer functions within 1e-5 absolute on O(1) values
(fp32, the chunk's products summed in another order: the reference
repeats B and C over the heads, the port multiplies per group); the
models within 1e-4 (test_torch_lm.py's fp32 rule), gradients within
1e-4 * max(1, their largest magnitude) (the shared block's and the
conv weights' reach ~30: fp32 rounding is relative); against the naive
recurrence 2e-4 / 1e-3 (the reference test's own); decode against
forward 3e-2 (the reference test's, in bf16).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.configs.base import ModelConfig as JModel, SSMConfig as JSSM
from repro.models import ssm as jssm
from repro.models.transformer import LanguageModel as JLM
from repro.models.transformer import init_params as j_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.models import layers, ssm
from repro_torch.models.transformer import (LanguageModel, cache_length,
                                            init_params, segment_plan)
from test_ssm import naive_ssd

LAYER_TOL = 1e-5
TOL = 1e-4
ARCHS = {"mamba2-2.7b": 3, "zamba2-2.7b": 8}
# vocab 100 pads to 112: the head masks the pad columns and the tied
# embedding's pad rows take a (zero) gradient
SHRINK = dict(vocab_size=100, dtype="float32")
FULL = {"mamba2-2.7b": 2_702_255_616, "zamba2-2.7b": 2_340_466_848}


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(ARCHS))
def test_ssm_configs_and_reduced_mirror_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(n_layers=8, d_model=32), dict(dtype="float32")):
        assert dataclasses.asdict(tbase.reduced(tc.model, **kw)) == \
            dataclasses.asdict(j_reduced(jc.model, **kw))
    assert tc.model.padded_vocab == jc.model.padded_vocab
    assert tc.dmd.param_filter == "all" and tc.dmd.snapshot_dtype == \
        "bfloat16"


def test_dense_init_scale():
    """std = scale / sqrt(fan_in), scale 0 gives zeros; scale 1 keeps the
    earlier draws bit for bit."""
    g = torch.Generator().manual_seed(0)
    half = layers.dense_init(g, (4, 4096), torch.float32, "cpu", 0.5)
    assert abs(float(half.std()) - 0.5 / 2.0) < 0.01
    g = torch.Generator().manual_seed(0)
    assert torch.equal(half * 2, layers.dense_init(g, (4, 4096),
                                                   torch.float32, "cpu"))
    zero = layers.dense_init(None, (3, 4, 8), torch.bfloat16, "cpu", 0.0)
    assert zero.dtype == torch.bfloat16 and not bool(zero.any())


# -- the layer functions -------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(3)
    u = rng.standard_normal((2, 9, 12), np.float32)
    w = rng.standard_normal((4, 12), np.float32)
    st = rng.standard_normal((2, 3, 12), np.float32) if with_state else None
    j_out, j_st = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
    out, new = ssm._causal_conv(_t(u), _t(w), None if st is None else _t(st))
    _close(out, j_out, LAYER_TOL)
    assert torch.equal(new, _t(np.asarray(j_st)))


def _ssd_inputs(B, S, H, P, G, N, seed, h0=False):
    rng = np.random.default_rng(seed)
    out = [rng.standard_normal((B, S, H, P), np.float32),
           rng.uniform(0.01, 0.3, (B, S, H)).astype(np.float32),
           -rng.uniform(0.1, 1.0, (H,)).astype(np.float32),
           rng.standard_normal((B, S, G, N), np.float32),
           rng.standard_normal((B, S, G, N), np.float32)]
    return out, (rng.standard_normal((B, H, P, N), np.float32) if h0
                 else None)


SSD_CASES = {
    "below-chunk": (24, 32, 1, False),     # Q = S
    "chunks": (64, 16, 1, False),          # 4 chunks
    "carried-h0": (48, 16, 1, True),
    "two-groups": (32, 8, 2, True),        # each group feeds 2 heads
}


@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_chunked_matches_reference(case):
    S, chunk, G, h0 = SSD_CASES[case]
    args, h = _ssd_inputs(2, S, 4, 8, G, 8, seed=S + G, h0=h0)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, args), chunk,
                              None if h is None else jnp.asarray(h))
    y, hf = ssd_chunked_t(args, chunk, h)
    assert y.dtype == hf.dtype == torch.float32
    _close(y, jy, LAYER_TOL)
    _close(hf, jh, LAYER_TOL)
    # the reference test's oracle: the recurrence one token at a time
    ny, nh = naive_ssd(*args, h0=h)
    np.testing.assert_allclose(y.numpy(), ny, atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(hf.numpy(), nh, atol=2e-4, rtol=1e-3)


def ssd_chunked_t(args, chunk, h0=None):
    return ssm.ssd_chunked(*map(_t, args), chunk,
                           None if h0 is None else _t(h0))


def test_intra_chunk_backward_gradcheck_in_float64():
    """The intra-chunk term's backward (it recomputes each chunk's masked
    scores) against the numerical Jacobian: two chunks, two groups of two
    heads."""
    rng = np.random.default_rng(7)
    B, nc, G, rep, Q, P = 1, 2, 2, 2, 5, 3
    dA = -rng.uniform(0.05, 0.5, (B, nc, G * rep, Q))
    cum = torch.from_numpy(np.cumsum(dA, -1)).requires_grad_(True)
    scores = torch.from_numpy(rng.standard_normal(
        (B, nc, G, Q, Q))).requires_grad_(True)
    xdt = torch.from_numpy(rng.standard_normal(
        (B, nc, G * rep, Q, P))).requires_grad_(True)
    assert torch.autograd.gradcheck(ssm._IntraChunk.apply,
                                    (cum, scores, xdt))


def test_ssd_gradient_at_the_configs_chunk_is_finite_and_pinned():
    """At the configs' chunk of 256, with the reference's init (A_log 0,
    so A = -1) and dt a softplus of normal draws, the reference's SSD
    gradient is NaN (it masks the decay after its exp, which overflows
    above the diagonal); the port's is finite and equals the reference's
    at chunk 64, where the reference's own stays finite (chunking is
    exact). fp32: within 1e-4 * max(1, the gradient's largest magnitude)
    (the chunks' products summed in other orders; dA reaches ~91)."""
    rng = np.random.default_rng(11)
    B, S, H, P, G, N = 1, 256, 2, 4, 1, 8
    x = rng.standard_normal((B, S, H, P), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(np.zeros((H,), np.float32))
    Bm = rng.standard_normal((B, S, G, N), np.float32)
    Cm = rng.standard_normal((B, S, G, N), np.float32)
    gy = rng.standard_normal((B, S, H, P), np.float32)
    gh = rng.standard_normal((B, H, P, N), np.float32)

    def ref_grads(chunk):
        def f(x, dt, A, Bm, Cm):
            y, h = jssm.ssd_chunked(x, dt, A, Bm, Cm, chunk)
            return jnp.sum(y * gy) + jnp.sum(h * gh)
        return jax.grad(f, argnums=(0, 1, 2, 3, 4))(
            *map(jnp.asarray, (x, dt, A, Bm, Cm)))

    assert not np.isfinite(np.asarray(ref_grads(256)[1])).all()
    want = ref_grads(64)
    args = [_t(a).requires_grad_(True) for a in (x, dt, A, Bm, Cm)]
    y, h = ssm.ssd_chunked(*args, 256)
    ((y * _t(gy)).sum() + (h * _t(gh)).sum()).backward()
    for name, a, w in zip(("dx", "ddt", "dA", "dB", "dC"), args, want):
        g = a.grad.numpy()
        assert np.isfinite(g).all(), name
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert np.abs(g - np.asarray(w)).max() <= 1e-4 * scale, name


def test_ssd_chunked_refuses_a_length_that_is_not_a_chunk_multiple():
    args, _ = _ssd_inputs(1, 40, 2, 4, 1, 4, seed=0)
    with pytest.raises(ValueError, match="not divisible by chunk 16"):
        ssd_chunked_t(args, 16)


def _layer_cfgs():
    kw = dict(d_model=32, dtype="float32")
    sk = dict(state_dim=8, head_dim=8, conv_width=4, expand=2, n_groups=1,
              chunk=8)
    return JModel(**kw, ssm=JSSM(**sk)), ModelConfig(**kw, ssm=SSMConfig(**sk))


def _layer_params(seed=0):
    """The reference's SSM params with nonzero A_log, dt_bias, skip_d and
    norm_scale (its init makes them zeros), as numpy."""
    jc, _ = _layer_cfgs()
    p = jax.tree_util.tree_map(np.asarray, jssm.ssm_init(
        jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    for k in ("A_log", "dt_bias", "skip_d", "norm_scale"):
        p[k] = (0.3 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def test_apply_ssm_prefill_and_decode_match_reference():
    """Forward without a state, prefill into a zero state, then three
    O(1) decode steps: the outputs and every state tensor."""
    jc, tc = _layer_cfgs()
    jp = _layer_params()
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(1).standard_normal((2, 16, 32), np.float32)
    j_out, _ = jssm.apply_ssm(jnp.asarray(x), jp, jc)
    out, none = ssm.apply_ssm(_t(x), tp, tc)
    _close(out, j_out, LAYER_TOL)
    assert none is None
    jst = jssm.init_ssm_state(2, jc, jnp.float32)
    st = ssm.init_ssm_state(2, tc, torch.float32, "cpu")
    assert [tuple(t.shape) for t in st] == [tuple(t.shape) for t in jst]
    assert st.h.dtype == torch.float32
    j_out, jst = jssm.apply_ssm(jnp.asarray(x[:, :8]), jp, jc, state=jst)
    out, st2 = ssm.apply_ssm(_t(x[:, :8]), tp, tc, state=st)
    assert all(a is b for a, b in zip(st2, st))        # written in place
    _close(out, j_out, LAYER_TOL)
    for t in range(8, 11):
        j_out, jst = jssm.apply_ssm(jnp.asarray(x[:, t:t + 1]), jp, jc,
                                    state=jst)
        out, st = ssm.apply_ssm(_t(x[:, t:t + 1]), tp, tc, state=st)
        _close(out, j_out, LAYER_TOL)
        for a, b in zip(st, jst):
            _close(a, b, LAYER_TOL)


def test_apply_ssm_grads_match_jax_grad():
    jc, tc = _layer_cfgs()
    jp = _layer_params(2)
    x = np.random.default_rng(4).standard_normal((2, 16, 32), np.float32)
    g = np.random.default_rng(5).standard_normal((2, 16, 32), np.float32)

    def ref_loss(p, x):
        return jnp.sum(jssm.apply_ssm(x, p, jc)[0] * g)
    j_gp, j_gx = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    tp = params_from_jax(jp, device="cpu")
    leaves = leaves_with_paths(tp)
    req = {path: t.clone().requires_grad_(True) for path, t in leaves}
    xt = _t(x).requires_grad_(True)
    out, _ = ssm.apply_ssm(xt, map_with_paths(lambda p, _: req[p], tp), tc)
    (out * _t(g)).sum().backward()
    _close(xt.grad, j_gx, LAYER_TOL)
    want = dict(leaves_with_paths(params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_gp), device="cpu")))
    for path, t in req.items():
        _close(t.grad, want[path], 1e-4)


# -- the models ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    n = ARCHS[arch]
    jm = j_reduced(j_get_config(arch).model, n_layers=n, **SHRINK)
    tm = reduced(get_config(arch).model, n_layers=n, **SHRINK)
    jlm = JLM(jm, head_tp=False, chunk_k=16, scan_layers=False)
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    return jlm, jp, LanguageModel(tm, chunk_k=16, device="cpu"), \
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    jlm = _models(arch)[0]
    return {"forward": jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})),
            "loss": jax.jit(jax.value_and_grad(
                lambda p, t: jlm.loss(p, {"tokens": t})[0])),
            "prefill": jax.jit(lambda p, t, c: jlm.prefill(
                p, {"tokens": t}, c)),
            "decode": jax.jit(lambda p, t, c: jlm.decode_step(
                p, {"tokens": t}, c))}


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, SHRINK["vocab_size"], size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ssm_param_tree_and_stack_dims_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    mine = tlm.init(torch.Generator().manual_seed(1))
    ref = dict(leaves_with_paths(tp))
    got = dict(leaves_with_paths(mine))
    assert sorted(got) == sorted(ref)
    for path, leaf in got.items():
        assert leaf.shape == ref[path].shape and \
            leaf.dtype == ref[path].dtype, path
    assert tlm.param_count(mine) == jlm.param_count(jp)
    assert tlm.param_stack_dims() == jlm.param_stack_dims()
    assert [tuple(s) for s in segment_plan(tlm.cfg)] == \
        [tuple(s) for s in jlm.plan]
    a_log = "/seg0/ssm/A_log" if arch.startswith("mamba") \
        else "/seg0/mamba/ssm/A_log"
    assert got[a_log].dtype == torch.float32 and not bool(got[a_log].any())
    if arch.startswith("zamba"):
        assert [s.kind for s in tlm.plan] == ["zamba", "mamba"]
        assert got["/seg0/mamba/ssm/in_proj/x"].shape[:2] == (1, 6)
        assert tlm.param_stack_dims()["shared_block"]["attn"]["wq"] == 0


@pytest.mark.parametrize("arch", list(FULL))
def test_full_size_meta_init_matches_reference_abstract_init(arch):
    jc, tc = j_get_config(arch).model, get_config(arch).model
    ref = dict(leaves_with_paths(j_init_params(jc, abstract=True)))
    got = dict(leaves_with_paths(init_params(tc, device="meta")))
    assert sorted(got) == sorted(ref)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == tuple(ref[path].shape), path
        assert str(leaf.dtype).removeprefix("torch.") == \
            str(ref[path].dtype), path
    assert sum(t.numel() for t in got.values()) == FULL[arch]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ssm_forward_loss_and_grads_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    toks = _tokens(2, 32, seed=1)                   # 2 chunks of 32
    jl, _ = jf["forward"](jp, jnp.asarray(toks))
    tl, aux = tlm.forward(tp, {"tokens": _t(toks)})
    _close(tl, jl, TOL)
    assert float(aux) == 0.0
    assert bool((tl[..., tlm.cfg.vocab_size:] == -1e30).all())
    jloss, jgrads = jf["loss"](jp, jnp.asarray(toks))
    leaves = leaves_with_paths(tp)
    req = [x.clone().requires_grad_(True) for _, x in leaves]
    by = {p: r for (p, _), r in zip(leaves, req)}
    rm = LanguageModel(tlm.cfg, chunk_k=16, remat="block", device="cpu")
    losses, grads = [], []
    for model in (tlm, rm):
        loss = model.loss(map_with_paths(lambda p, _: by[p], tp),
                          {"tokens": _t(toks)})[0]
        losses.append(loss)
        grads.append(torch.autograd.grad(loss, req))
    _close(losses[0], jloss, TOL)
    # remat recomputes each super-block with the same arithmetic
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    want = dict(leaves_with_paths(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")))
    for (path, _), g in zip(leaves, grads[0]):
        scale = max(1.0, float(np.abs(np.asarray(want[path])).max()))
        assert np.abs(g.numpy() - np.asarray(want[path])).max() <= \
            TOL * scale, (path, scale)
    emb = dict(zip([p for p, _ in leaves], grads[0]))["/emb"]
    assert not bool(emb[tlm.cfg.vocab_size:].any())  # pad rows: zero
    if arch.startswith("zamba"):
        # the shared block's gradient sums its one invocation per group
        assert float(dict(zip([p for p, _ in leaves], grads[0]))[
            "/shared_block/attn/wq"].abs().max()) > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ssm_prefill_and_decode_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    toks = _tokens(2, 32, seed=2)
    jc, tc = jlm.init_cache(2, 48), tlm.init_cache(2, 48)
    jl, jc = jf["prefill"](jp, jnp.asarray(toks), jc)
    tl, tc = tlm.prefill(tp, {"tokens": _t(toks)}, tc)
    _close(tl, jl, TOL)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jf["decode"](jp, jnp.asarray(nxt), jc)
        tl, tc = tlm.decode_step(tp, {"tokens": _t(nxt)}, tc)
        _close(tl, jl, TOL)
    if arch.startswith("mamba"):
        assert cache_length(tc) == 0               # no KV cache: no length
        for a, b in zip(tc["seg0"], jc["seg0"]):
            _close(a, b, TOL)
    else:
        assert cache_length(tc) == 36
        assert tc["seg0"]["shared"].length == 36
        _close(tc["seg0"]["shared"].k[:, :, :36],
               jc["seg0"]["shared"].k[:, :, :36], TOL)
        for a, b in zip(tc["seg0"]["mamba"], jc["seg0"]["mamba"]):
            _close(a, b, TOL)
        for a, b in zip(tc["seg1"], jc["seg1"]):   # the remainder
            _close(a, b, TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_ssm_decode_tracks_forward(arch):
    """Per-token decode through the states tracks the full forward (the
    reference's tests/test_ssm.py check, in bf16 at its tolerance)."""
    n = ARCHS[arch]
    tm = reduced(get_config(arch).model, n_layers=n)
    model = LanguageModel(tm, chunk_k=16, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(1, 16, seed=3)).long()
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": toks})
        caches = model.init_cache(1, 16)
        _, caches = model.prefill(params, {"tokens": toks[:, :8]}, caches)
        for t in range(8, 16):
            lt, caches = model.decode_step(
                params, {"tokens": toks[:, t:t + 1]}, caches)
            np.testing.assert_allclose(lt[:, 0].numpy(), full[:, t].numpy(),
                                       atol=3e-2, rtol=3e-2)
