"""The port's MoE family (``models/moe.py``, the ``moe`` / ``moe_pair``
segments of ``models/transformer.py``, ``configs/{qwen3_moe,
llama4_maverick}.py``) against the reference on the CPU.

  * ``apply_moe``: forward (out, aux), the routing (``top_i`` and the
    experts' ``sel_idx``, exactly) and every gradient against ``jax.grad``
    of the reference's ``apply_moe``, with capacity drops, top-1 with a
    shared expert, at high capacity against the reference test's dense
    oracle, and with forced ties (the reference's lower-index-first rule).
  * The dispatch and combine Functions: ``gradcheck`` in float64 (each
    backward is the other's forward).
  * Reduced Qwen3 (every layer MoE) and Llama4 (a dense-MoE pair and a
    dense remainder layer): the param tree, ``param_stack_dims``,
    ``forward`` / ``loss`` / ``prefill`` / ``decode_step`` against the
    reference's, on the reference's own weights carried by
    ``params_from_jax``; remat bit-identical and the gradients against
    ``jax.grad``.

Tolerances: fp32 within 1e-5 absolute for the layer (O(1) values,
summation order over d <= 32) and 1e-4 for the models (test_torch_lm.py's
rule: a few layers of fp32 noise); routing indices exact; remat bit for
bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.configs.base import ModelConfig as JModel, MoEConfig as JMoE
from repro.models import moe as jmoe
from repro.models.transformer import LanguageModel as JLM
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.models import layers, moe
from repro_torch.models.transformer import LanguageModel, segment_plan
from test_moe import dense_moe_oracle

LAYER_TOL = 1e-5
TOL = 1e-4
SHRINK = dict(d_model=32, d_ff=64, vocab_size=128, n_heads=2, n_kv_heads=1,
              head_dim=16, dtype="float32")
ARCHS = {"qwen3-moe-30b-a3b": 2, "llama4-maverick-400b-a17b": 3}


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


# -- the layer ----------------------------------------------------------------

def _layer_cfgs(top_k, cf, shared=0):
    kw = dict(d_model=16, act="silu", dtype="float32")
    mk = dict(n_experts=8, top_k=top_k, expert_d_ff=32, capacity_factor=cf,
              n_shared_experts=shared, shared_d_ff=24 if shared else 0)
    return JModel(**kw, moe=JMoE(**mk)), ModelConfig(**kw, moe=MoEConfig(**mk))


def _ref_routing(x, p, cfg):
    """The reference's top_i and sel_idx, by its own steps."""
    m = cfg.moe
    cap = min(max(int(x.shape[1] * m.top_k / m.n_experts
                      * m.capacity_factor), 1), x.shape[1])
    probs = jax.nn.softmax(x.astype(jnp.float32) @ p["router"], axis=-1)
    top_p, top_i = jax.lax.top_k(probs, m.top_k)
    gate = jax.vmap(jax.vmap(
        lambda ti, tp: jnp.zeros((m.n_experts,), jnp.float32).at[ti].set(
            tp)))(top_i, top_p)
    sel_gate, sel_idx = jax.lax.top_k(gate.transpose(0, 2, 1), cap)
    return top_i, sel_idx, sel_gate


def _tied(jp, x):
    """Forced ties: experts 1, 2 and 3 share expert 0's router column, and
    the tokens come in groups of four equal rows."""
    r = np.asarray(jp["router"]).copy()
    r[:, 1:4] = r[:, :1]
    return dict(jp, router=jnp.asarray(r)), np.repeat(x[:, ::4], 4, axis=1)


CASES = {
    "drops": (2, 1.25, 0),        # cap 5 of 16: routed tokens dropped
    "shared": (1, 1.25, 1),       # top-1 with the shared expert's MLP
    "oracle": (2, 8.0, 0),        # cap 16: nothing drops
    "ties": (2, 0.75, 0),         # cap 3 over groups of 4 equal tokens
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_reference(case):
    top_k, cf, shared = CASES[case]
    jc, tc = _layer_cfgs(top_k, cf, shared)
    jp = jax.jit(lambda k: jmoe.moe_init(k, jc))(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((2, 16, 16), np.float32)
    if case == "ties":
        jp, x = _tied(jp, x)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    j_out, j_aux = jax.jit(lambda p, x: jmoe.apply_moe(x, p, jc))(
        jp, jnp.asarray(x))
    out, aux = moe.apply_moe(torch.from_numpy(x), tp, tc)
    _close(out, j_out, LAYER_TOL)
    _close(aux, j_aux, LAYER_TOL)
    assert out.dtype == torch.float32 and aux.dtype == torch.float32

    want_top, want_sel, want_gate = jax.jit(
        lambda x, p: _ref_routing(x, p, jc))(jnp.asarray(x), jp)
    want_top, want_sel, want_gate = (np.asarray(a) for a in
                                     (want_top, want_sel, want_gate))
    _, top_i, sel_gate, routing = moe.route(torch.from_numpy(x), tp, tc)
    np.testing.assert_array_equal(top_i.numpy(), want_top)
    np.testing.assert_array_equal(routing.sel_idx.numpy(), want_sel)
    _close(sel_gate, np.where(want_gate > 0, want_gate, 0.0), LAYER_TOL)
    kept = int((want_gate > 0).sum())
    if case == "drops":
        assert kept < x.shape[0] * x.shape[1] * top_k      # drops present
    if case == "oracle":
        assert kept == x.shape[0] * x.shape[1] * top_k     # none drop
        _close(out, dense_moe_oracle(jnp.asarray(x), jp, jc), 1e-4)
    if case == "ties":
        # the tied experts hold ties in every token's top-k and in their
        # own choice of tokens, resolved lower index first
        assert (want_top[..., 0] < want_top[..., 1]).any()
        assert (want_sel[:, :4, 0] % 4 == 0).all()

    g = np.random.default_rng(2).standard_normal(x.shape, np.float32)

    def ref_loss(p, x):
        o, a = jmoe.apply_moe(x, p, jc)
        return jnp.sum(o * g) + a
    j_gp, j_gx = jax.jit(jax.grad(ref_loss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    leaves = leaves_with_paths(tp)
    req = {path: t.clone().requires_grad_(True) for path, t in leaves}
    tree = map_with_paths(lambda path, _: req[path], tp)
    xt = torch.from_numpy(x).requires_grad_(True)
    o, a = moe.apply_moe(xt, tree, tc)
    ((o * torch.from_numpy(g)).sum() + a).backward()
    _close(xt.grad, j_gx, LAYER_TOL)
    want = dict(leaves_with_paths(params_from_jax(
        jax.tree_util.tree_map(np.asarray, j_gp), device="cpu")))
    assert sorted(want) == sorted(req)
    for path, t in req.items():
        _close(t.grad, want[path], LAYER_TOL)


def test_aux_loss_and_capacity_are_the_reference_expressions():
    E, T = 8, 256
    rng = np.random.default_rng(0)
    probs = rng.dirichlet(np.ones(E), size=(1, T)).astype(np.float32)
    top = rng.integers(0, E, (1, T, 2))
    _close(moe.aux_load_balance_loss(torch.from_numpy(probs),
                                     torch.from_numpy(top), E),
           jmoe.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(top),
                                      E), LAYER_TOL)
    for S, k, E, cf in [(16, 2, 8, 1.25), (1, 8, 128, 1.25),
                        (4096, 8, 128, 1.25), (4096, 1, 128, 1.25),
                        (7, 3, 5, 0.1), (64, 8, 128, 1.25)]:
        cfg = ModelConfig(moe=MoEConfig(n_experts=E, top_k=k,
                                        capacity_factor=cf))
        assert moe.capacity(S, cfg) == min(max(int(S * k / E * cf), 1), S)
    assert moe.capacity(4096, get_config("qwen3-moe-30b-a3b").model) == 320
    assert moe.capacity(1, get_config("qwen3-moe-30b-a3b").model) == 1


@pytest.mark.parametrize("fn", ["dispatch", "combine"])
def test_dispatch_and_combine_gradcheck_in_float64(fn):
    """Each Function's backward is the other's forward: gradcheck holds it
    to the numerical Jacobian (drops and zero-gate fills included)."""
    _, tc = _layer_cfgs(2, 1.25)
    p = moe.moe_init(torch.Generator().manual_seed(0), tc, "cpu")
    x = torch.randn((2, 16, 16), generator=torch.Generator().manual_seed(1))
    _, _, _, r = moe.route(x, p, tc)
    assert not bool(r.kept.all())              # zero-gate fills present
    assert bool((r.flat < 0).any())            # drops present
    if fn == "dispatch":
        inp = x.double().requires_grad_(True)
        f = lambda t: moe.dispatch(t, r)       # noqa: E731
    else:
        inp = torch.randn(r.sel_idx.shape + (16,), dtype=torch.float64,
                          requires_grad=True)
        f = lambda t: moe.combine(t, r)        # noqa: E731
    assert torch.autograd.gradcheck(f, (inp,))


def test_combine_sums_in_ascending_expert_order_in_its_dtype():
    """Three bf16 contributions whose sum depends on the order: the
    combine adds them from 0 in ascending expert order, rounding each
    partial sum to bf16, as the reference's sequential scatter-add."""
    E, C, D = 4, 1, 1
    sel_idx = torch.zeros((1, E, C), dtype=torch.long)
    kept = torch.tensor([[[True], [False], [True], [True]]])
    top_i = torch.tensor([[[3, 0, 2]]])
    r = moe.Routing(sel_idx, kept, top_i)
    ye = torch.tensor([1.0, 5.0, 2 ** -8, 2 ** -8],
                      dtype=torch.bfloat16).reshape(1, E, C, D)
    want = torch.zeros((), dtype=torch.bfloat16)
    for e in (0, 2, 3):
        want = want + ye[0, e, 0, 0]
    assert float(want) == 1.0                   # 1 + 2^-8 rounds to 1
    assert moe.combine(ye, r).item() == want.item()
    assert moe.dispatch(ye[:, :1, 0], r)[0, 1].item() == 0.0   # not kept


def test_dense_init_draws_a_large_leaf_in_row_slices(monkeypatch):
    """Up to ``DRAW_ELEMS`` a leaf is one slice, the values of one fp32
    draw (TinyLlama's leaves keep their values); above it, consecutive
    slices of whole rows, each scaled by the leaf's own fan-in."""
    g = torch.Generator().manual_seed(0)
    whole = layers.dense_init(g, (3, 64, 32), torch.bfloat16, "cpu")
    g = torch.Generator().manual_seed(0)
    want = (torch.randn((3, 64, 32), generator=g) / 8.0).to(torch.bfloat16)
    assert torch.equal(whole, want)
    monkeypatch.setattr(layers, "DRAW_ELEMS", 100)
    g = torch.Generator().manual_seed(0)
    sliced = layers.dense_init(g, (3, 64, 32), torch.bfloat16, "cpu")
    g = torch.Generator().manual_seed(0)
    rows = torch.cat([torch.randn((3, 32), generator=g)
                      for _ in range(64)]) / 8.0
    assert sliced.shape == (3, 64, 32) and sliced.dtype == torch.bfloat16
    assert torch.equal(sliced, rows.reshape(3, 64, 32).to(torch.bfloat16))
    meta = layers.dense_init(None, (48, 128, 2048, 768), torch.bfloat16,
                             "meta")
    assert meta.shape == (48, 128, 2048, 768) and meta.is_meta


# -- the models ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    n = ARCHS[arch]
    jm = j_reduced(j_get_config(arch).model, n_layers=n, **SHRINK)
    tm = reduced(get_config(arch).model, n_layers=n, **SHRINK)
    jlm = JLM(jm, head_tp=False, chunk_k=16, scan_layers=False)
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jlm, jp, LanguageModel(tm, chunk_k=16, device="cpu"), tp


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    """The reference model's entry points, compiled once per arch."""
    jlm = _models(arch)[0]
    return {"forward": jax.jit(lambda p, t: jlm.forward(p, {"tokens": t})),
            "loss": jax.jit(lambda p, t: jlm.loss(p, {"tokens": t})),
            "prefill": jax.jit(lambda p, t, c: jlm.prefill(
                p, {"tokens": t}, c)),
            "decode": jax.jit(lambda p, t, c: jlm.decode_step(
                p, {"tokens": t}, c))}


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(
        1, SHRINK["vocab_size"], size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_param_tree_and_stack_dims_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    mine = tlm.init(torch.Generator().manual_seed(1))
    ref = dict(leaves_with_paths(tp))
    got = dict(leaves_with_paths(mine))
    assert sorted(got) == sorted(ref)
    for path, leaf in got.items():
        assert leaf.shape == ref[path].shape and \
            leaf.dtype == ref[path].dtype, path
    assert got["/seg0/moe/router" if arch.startswith("qwen3")
               else "/seg0/moe/moe/router"].dtype == torch.float32
    assert tlm.param_count(mine) == jlm.param_count(jp)
    assert tlm.param_stack_dims() == jlm.param_stack_dims()
    assert [tuple(s) for s in segment_plan(tlm.cfg)] == \
        [tuple(s) for s in jlm.plan]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_moe_forward_prefill_decode_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    toks = _tokens(2, 21)
    jl, jaux = jf["forward"](jp, jnp.asarray(toks))
    tl, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl, TOL)
    _close(aux, jaux, LAYER_TOL)
    assert float(aux) > 0 and aux.dtype == torch.float32
    jloss, _ = jf["loss"](jp, jnp.asarray(toks))
    tloss, parts = tlm.loss(tp, {"tokens": torch.from_numpy(toks)})
    _close(tloss, jloss, TOL)
    assert float(tloss) == float(parts["ce"] + parts["aux"])

    jc, tc = jlm.init_cache(2, 40), tlm.init_cache(2, 40)
    jl, jc = jf["prefill"](jp, jnp.asarray(toks), jc)
    tl, tc = tlm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl, TOL)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jf["decode"](jp, jnp.asarray(nxt), jc)
        tl, tc = tlm.decode_step(tp, {"tokens": torch.from_numpy(nxt)}, tc)
        _close(tl, jl, TOL)
    if arch.startswith("llama4"):
        assert sorted(tc["seg0"]) == ["dense", "moe"]
        for kind in ("dense", "moe"):
            assert tc["seg0"][kind].length == 24
            _close(tc["seg0"][kind].k[:, :, :24],
                   jc["seg0"][kind].k[:, :, :24], TOL)
        assert tc["seg1"].length == 24              # the dense remainder
    else:
        assert tc["seg0"].length == int(jc["seg0"].length[0]) == 24


def test_moe_remat_bit_identical_and_grads_match_reference():
    arch = "qwen3-moe-30b-a3b"
    jlm, jp, plain, tp = _models(arch)
    toks = _tokens(2, 16, seed=3)
    batch = {"tokens": torch.from_numpy(toks)}
    rm = LanguageModel(plain.cfg, chunk_k=16, remat="block", device="cpu")

    def loss_and_grads(model):
        leaves = leaves_with_paths(tp)
        req = [x.detach().clone().requires_grad_(True) for _, x in leaves]
        by = {p: r for (p, _), r in zip(leaves, req)}
        loss = model.loss(map_with_paths(lambda p, _: by[p], tp), batch)[0]
        return loss, torch.autograd.grad(loss, req)
    base_loss, base_grads = loss_and_grads(plain)
    loss, grads = loss_and_grads(rm)
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base_grads):
        assert torch.equal(a, b)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, {"tokens": jnp.asarray(toks)})[0]))(jp)
    _close(loss, jloss, TOL)
    want = dict(leaves_with_paths(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")))
    for (path, _), g in zip(leaves_with_paths(tp), grads):
        _close(g, want[path], TOL)
