"""The remaining dense decoders (``configs/{minicpm_2b,granite_20b,
gemma3_27b}.py``; the GELU MLPs of ``models/layers.py``; the ring caches
of ``models/attention.py``; the ``gemma`` / ``dense_local`` segments of
``models/transformer.py``) against the reference on the CPU.

  * The mirrored configs field for field, and their reduced forms.
  * Both GELU MLPs (gated ``gelu``, plain ``gelu_mlp``) against
    ``repro.models.layers.apply_mlp``: the tanh approximation, as
    ``jax.nn.gelu`` computes by default.
  * Ring attention against the reference's ``attend``: a prefill into a
    fresh ring (prompts shorter than, equal to and longer than the window
    of 8) and decode steps that wrap it, outputs and ring contents.
  * Reduced MiniCPM (the reference run with its ``pad_heads_to=16``
    head-TP padding, which the port leaves out), Granite (one KV head)
    and Gemma3 (one super-block of 5 local + 1 global layer and a 2-layer
    local tail, window 8): the param tree, ``param_stack_dims``,
    ``forward`` / ``loss`` / every gradient, remat bit for bit, and
    ``prefill`` / ``decode_step`` through wrapped rings, on the
    reference's own weights carried by ``params_from_jax``.
  * The full-size meta init against the reference's abstract init; the
    engine serving MiniCPM and Granite as the reference's engine does,
    and refusing Gemma3's ring caches as the reference's does.
  * Each reduced launcher through a DMD jump against
    ``repro.train.Trainer``; ``check_fits`` refusing the full depths.
  * On a card (marker ``gpu``): a Gemma3 super-block card against CPU,
    and a reduced Gemma3 Trainer graphed = eager.

Tolerances (fp32): layer functions within 1e-5 absolute on O(1) values
(summation order over d <= 128); the models within 1e-4 (test_torch_lm.py's
rule), gradients within 1e-4 * max(1, their largest magnitude) (fp32
rounding is relative); the Trainers' losses to rtol 1e-5 until the first
jump and 2e-3 on the jump step (test_torch_lm_train.py's rule).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import LanguageModel as JLM
from repro.models.transformer import init_params as j_init_params
from repro.serve import ServeConfig as JServeConfig, ServeEngine as JEngine
from repro.train import Trainer as JTrainer
from repro_torch.configs import base as tbase
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import (LanguageModel, cache_length,
                                            init_params, segment_plan)
from repro_torch.serve import ServeConfig, ServeEngine

LAYER_TOL = 1e-5
TOL = 1e-4
ARCHS = ("minicpm-2b", "granite-20b", "gemma3-27b")
# the reduced models: vocab 100 pads to 112 (the head masks the pad
# columns); gemma at one super-block and a 2-layer local tail, window 8
SHRINK = dict(vocab_size=100, dtype="float32")
ARCH_SHRINK = {"minicpm-2b": {}, "granite-20b": {},
               "gemma3-27b": dict(n_layers=8, sliding_window=8)}
# the reference launcher's head padding (src/repro/launch/train.py)
PAD_HEADS = {"minicpm-2b": 16, "granite-20b": 0, "gemma3-27b": 0}
# the reference's abstract init's counts, summed in Python integers (its
# LanguageModel.param_count multiplies shapes in int32, which wraps past
# 2^31 at granite's and gemma's full widths)
FULL = {"minicpm-2b": 2_724_915_456, "granite-20b": 20_315_756_544,
        "gemma3-27b": 27_008_319_744}
# the bytes an H100 80GB HBM3 reports (torch.cuda.get_device_properties'
# total_memory), for check_fits
CARD = 85_017_493_504


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


def _t(x):
    return torch.from_numpy(np.array(x))


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_dense_configs_and_reduced_mirror_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(n_layers=8, d_model=32), dict(dtype="float32")):
        assert dataclasses.asdict(tbase.reduced(tc.model, **kw)) == \
            dataclasses.asdict(j_reduced(jc.model, **kw))
    assert tc.model.padded_vocab == jc.model.padded_vocab
    assert [tuple(s) for s in segment_plan(tc.model)] == \
        [tuple(s) for s in JLM(jc.model).plan]


# -- the MLPs --------------------------------------------------------------------

@pytest.mark.parametrize("act", ["gelu", "gelu_mlp"])
def test_gelu_mlps_match_reference(act):
    cfg = dataclasses.replace(reduced(get_config("gemma3-27b").model,
                                      dtype="float32"), act=act)
    jcfg = dataclasses.replace(j_reduced(j_get_config("gemma3-27b").model,
                                         dtype="float32"), act=act)
    jp = jax.tree_util.tree_map(np.asarray, jlayers.mlp_init(
        jax.random.PRNGKey(3), jcfg))
    mine = tlayers.mlp_init(torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(mine) == sorted(jp)               # no gate for gelu_mlp
    assert ("w_gate" in mine) == (act == "gelu")
    x = np.random.default_rng(4).standard_normal((2, 5, cfg.d_model),
                                                 np.float32) * 2
    want = np.asarray(jlayers.apply_mlp(jnp.asarray(x), jp, jcfg))
    got = tlayers.apply_mlp(_t(x), params_from_jax(jp, device="cpu"), cfg)
    _close(got, want, LAYER_TOL)
    # the exact erf form is another function, beyond the tolerance
    h = _t(x) @ _t(jp["w_in"])
    assert float((torch.nn.functional.gelu(h) - tlayers.gelu(h)).abs()
                 .max()) > 10 * LAYER_TOL


# -- ring attention --------------------------------------------------------------

def _attn_cfgs():
    kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=16,
              dtype="float32", sliding_window=8)
    return (j_reduced(j_get_config("gemma3-27b").model, **kw),
            reduced(get_config("gemma3-27b").model, **kw))


@pytest.mark.parametrize("S", [5, 8, 13, 21])
def test_ring_prefill_and_decode_match_reference(S):
    """A prompt of S tokens into a fresh ring of window W = 8, then 11
    decode steps (every ring wraps at least once): each step's output and
    the ring's k, v, slot positions and length."""
    jc, tc = _attn_cfgs()
    W, B = tc.sliding_window, 2
    jp = jax.tree_util.tree_map(np.asarray, jattn.attn_init(
        jax.random.PRNGKey(5), jc))
    tp = params_from_jax(jp, device="cpu")
    x = np.random.default_rng(S).standard_normal((B, S + 11, 32),
                                                 np.float32)
    jcache = jattn.init_ring_cache(B, W, 2, 16, jnp.float32)
    cache = tattn.init_ring_cache(B, W, 2, 16, torch.float32, "cpu")
    assert cache.pos.dtype == torch.int32 and not cache.length
    for a, b in ((0, S),) + tuple((t, t + 1) for t in range(S, S + 11)):
        pos = np.broadcast_to(np.arange(a, b), (B, b - a))
        jout, jcache = jattn.attend(
            jnp.asarray(x[:, a:b]), jp, jc, positions=jnp.asarray(pos),
            window=W, cache=jcache, head_tp=False, chunk_k=4)
        out, new = tattn.attend(_t(x[:, a:b]), tp, tc, positions=_t(pos),
                                window=W, cache=cache, chunk_k=4)
        assert new.k is cache.k and new.pos is cache.pos   # in place
        cache = new
        _close(out, jout, LAYER_TOL)
        _close(cache.k, jcache.k, LAYER_TOL)
        _close(cache.v, jcache.v, LAYER_TOL)
        np.testing.assert_array_equal(cache.pos.numpy(),
                                      np.asarray(jcache.pos))
        assert cache.length == int(jcache.length) == b
    with pytest.raises(ValueError, match="fresh"):
        tattn.attend(_t(x[:, :3]), tp, tc, positions=_t(pos[:, :1].repeat(
            3, 1)), window=W, cache=cache)


def test_blockwise_attention_takes_key_positions():
    """Keys at out-of-order absolute positions (a ring's slots; -1 empty)
    against the reference's core."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 1, 4, 16), np.float32)
    k = rng.standard_normal((2, 8, 2, 16), np.float32)
    v = rng.standard_normal((2, 8, 2, 16), np.float32)
    kp = np.array([16, 9, 10, 11, 12, 13, -1, 15], np.int32)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=8, q_offset=16, kv_len=jnp.asarray(17),
        k_positions=jnp.asarray(kp), chunk_k=4)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=True,
                                    window=8, q_offset=16, kv_len=17,
                                    k_positions=_t(kp), chunk_k=4)
    _close(got, want, LAYER_TOL)


# -- the models --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    kw = dict(SHRINK, **ARCH_SHRINK[arch])
    jm = j_reduced(j_get_config(arch).model, **kw)
    tm = reduced(get_config(arch).model, **kw)
    jlm = JLM(jm, head_tp=False, chunk_k=16, scan_layers=False,
              pad_heads_to=PAD_HEADS[arch])
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


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_param_tree_and_stack_dims_match_reference(arch):
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
    assert [tuple(s) for s in tlm.plan] == [tuple(s) for s in jlm.plan]
    if arch.startswith("granite"):
        assert got["/seg0/attn/wk"].shape[-1] == tlm.cfg.head_dim  # one head
        assert "w_gate" not in mine["seg0"]["mlp"]
    if arch.startswith("gemma"):
        assert [tuple(s) for s in tlm.plan] == [("gemma", 1),
                                                ("dense_local", 2)]
        assert got["/seg0/local/attn/wq"].shape[:2] == (1, 5)
        dims = tlm.param_stack_dims()
        assert dims["seg0"]["local"]["mlp"]["w_gate"] == 2
        assert dims["seg0"]["global"]["attn"]["wq"] == 1
        assert dims["seg1"]["ln1"]["scale"] == 1 and dims["emb"] == 0


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


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_forward_loss_and_grads_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    toks = _tokens(2, 24, seed=1)             # 3 windows of 8 for gemma
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
        assert bool(g.abs().max() > 0) or path == "/emb" or \
            "final_norm" in path, path


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_and_decode_match_reference(arch):
    """A 13-token prompt (gemma's rings of 8 wrap in the prefill), then 6
    decode steps: logits, cache lengths and the caches' contents."""
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    toks = _tokens(2, 13, seed=2)
    jc, tc = jlm.init_cache(2, 24), tlm.init_cache(2, 24)
    jl, jc = jf["prefill"](jp, jnp.asarray(toks), jc)
    tl, tc = tlm.prefill(tp, {"tokens": _t(toks)}, tc)
    _close(tl, jl, TOL)
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jf["decode"](jp, jnp.asarray(nxt), jc)
        tl, tc = tlm.decode_step(tp, {"tokens": _t(nxt)}, tc)
        _close(tl, jl, TOL)
    assert cache_length(tc) == 19
    if arch.startswith("gemma"):
        for ring, jring in ((tc["seg0"]["local"], jc["seg0"]["local"]),
                            (tc["seg1"], jc["seg1"])):
            assert ring.length == 19 and ring.k.shape[-3] == 8
            np.testing.assert_array_equal(ring.pos.numpy(),
                                          np.asarray(jring.pos))
            _close(ring.k, jring.k, TOL)
        glob = tc["seg0"]["global"]
        _close(glob.k[..., :19, :, :], jc["seg0"]["global"].k[..., :19, :, :],
               TOL)
    else:
        _close(tc["seg0"].k[:, :, :19], jc["seg0"].k[:, :, :19], TOL)


# -- serving ---------------------------------------------------------------------

ENGINE = dict(n_slots=4, prompt_buckets=(4, 8), batch_buckets=(1, 2),
              max_new_tokens=5)
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [2, 4], [7, 1, 8, 2, 6, 1, 9, 3],
           [3, 1, 4, 1, 5, 9]]


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-20b"])
def test_engine_tokens_equal_the_reference_engine(arch):
    jlm, jp, tlm, tp = _models(arch)
    jlm = JLM(jlm.cfg, head_tp=False, chunk_k=16, scan_layers=False)
    jeng = JEngine(jlm, jp, JServeConfig(**ENGINE))
    eng = ServeEngine(tlm, tp, ServeConfig(**ENGINE))
    for p in PROMPTS:
        jeng.submit(p)
        eng.submit(p)
    want = {r.uid: r.tokens for r in jeng.run_until_drained()}
    got = {r.uid: r.tokens for r in eng.run_until_drained()}
    assert got == want
    assert eng.stats["prefill_dispatches"] == \
        jeng.stats["prefill_dispatches"]
    # and the port's own exact-length loop
    for r in PROMPTS[:2]:
        uid = PROMPTS.index(r)
        assert launch_serve.exact_greedy(tlm, tp, r, 5)[0] == got[uid]


def test_engine_refuses_gemma_as_the_reference_does():
    jlm, jp, tlm, tp = _models("gemma3-27b")
    with pytest.raises(NotImplementedError, match="segment kinds"):
        ServeEngine(tlm, tp, ServeConfig(**ENGINE))
    with pytest.raises(NotImplementedError, match="segment kinds"):
        JEngine(jlm, jp, JServeConfig(**ENGINE))
    with pytest.raises(NotImplementedError, match="segment kinds"):
        launch_serve.build("gemma3-27b", use_reduced=True, device="cpu")


@pytest.mark.parametrize("arch", ["minicpm-2b", "granite-20b"])
def test_serve_launcher_on_the_cpu(arch, capsys):
    done = launch_serve.main(["--arch", arch, "--reduced", "--requests",
                              "3", "--new-tokens", "2", "--swap-every", "2",
                              "--device", "cpu"])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert "3 requests, 6 tokens" in capsys.readouterr().out


# -- training ----------------------------------------------------------------------

STEPS = 32                  # warm-up 8 (steps // 4): the first jump at 31


def _ref_acfg(arch):
    """The reference launcher's ArchConfig for the same flags (fp32)."""
    acfg = j_get_config(arch)
    mc = j_reduced(acfg.model, dtype="float32")
    return dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, warmup_steps=min(
            acfg.dmd.warmup_steps, STEPS // 4)),
        train=dataclasses.replace(acfg.train, global_batch=8, seq_len=64))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_launcher_matches_reference_trainer(arch):
    """The launcher's ``run`` on the reduced config (fp32, the config's
    DMD on every param in a bf16 ring: m 14 for minicpm, its WSD
    schedule; m 8 for granite and gemma, whose reduced model is one
    gemma super-block) against ``repro.train.Trainer`` from the same
    injected init on the port's token stream, the reference's model
    built as its launcher builds it (minicpm with pad_heads_to 16)."""
    acfg = launch_train.configure(arch, steps=STEPS, reduced=True)
    acfg = dataclasses.replace(acfg, model=dataclasses.replace(
        acfg.model, dtype="float32"))
    m = 14 if arch.startswith("minicpm") else 8
    assert (acfg.dmd.m, acfg.dmd.snapshot_dtype, acfg.dmd.warmup_steps) == \
        (m, "bfloat16", 8)
    jac = _ref_acfg(arch)
    jlm = JLM(jac.model, head_tp=False, chunk_k=64,
              pad_heads_to=jac.parallel.pad_attn_heads_to)
    jp = jlm.init(jax.random.PRNGKey(0))

    ref_losses, ref_jumps = [], []
    jtr = JTrainer(jlm, jac)
    st = jtr.init_state()
    st = st._replace(params=jp, opt_state=jtr.opt.init(jp))
    j_final = jtr.fit(
        ({k: jnp.asarray(v.numpy()) for k, v in b.items()}
         for b in synthetic_lm_batches(0, 8, 64, jac.model.vocab_size,
                                       device="cpu")), STEPS, state=st,
        on_metrics=lambda t, mt: (ref_losses.append(float(mt["loss"])),
                                  "mean_rank" in mt and ref_jumps.append(t)))

    model = launch_train.make_model(acfg, reduced=True, device="cpu")
    trainer = launch_train.make_trainer(acfg, model)
    state = trainer.init_state(params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    losses, jumps = [], []
    trainer, state = launch_train.run(
        acfg, model, steps=STEPS, log_every=0, trainer=trainer, state=state,
        on_metrics=lambda t, mt: (losses.append(float(mt["loss"])),
                                  "mean_rank" in mt and jumps.append(t)))
    assert jumps == ref_jumps and jumps and int(state.step) == STEPS
    k = jumps[0]
    np.testing.assert_allclose(losses[:k], ref_losses[:k], rtol=1e-5)
    np.testing.assert_allclose(losses[k], ref_losses[k], rtol=2e-3)
    assert np.isfinite(losses).all()
    # every leaf in the bf16 ring, laid out as the reference's: one system
    # per layer (gemma's local layers each their own)
    buckets = trainer.acc.arena_for(state.params)
    refs = jtr.acc.arena_for(j_final.params)
    assert sorted(buckets) == sorted(refs)
    for key, b in buckets.items():
        r = refs[key]
        assert (b.m, b.n_sys, b.n_blocks) == (r.m, r.n_sys, r.n_blocks), key
        assert b.m == m


@pytest.mark.parametrize("arch,full,cut,per", [
    ("minicpm-2b", 40, 23, 44), ("granite-20b", 52, 4, 32),
    ("gemma3-27b", 62, 2, 32)])
def test_check_fits_refuses_full_depth(arch, full, cut, per):
    """The state's bytes a param (bf16 param, adamw's fp32 moments, the
    fp32 sum and bf16 gradient, the bf16 ring of m: 14 for minicpm, 8 for
    the others): the full depths exceed 90% of an 80 GB H100, the deepest
    admitted depths do not, one layer more does."""
    for n, ok in ((full, False), (cut, True), (cut + 1, False)):
        acfg = launch_train.configure(arch, steps=100, n_layers=n)
        model = launch_train.make_model(acfg, device="cpu")
        n_p = launch_train.param_count(model)
        assert sum(launch_train.state_bytes(acfg, n_p).values()) == \
            per * n_p
        if ok:
            assert launch_train.check_fits(acfg, n_p, CARD) == per * n_p
        else:
            with pytest.raises(RuntimeError, match="cut the depth"):
                launch_train.check_fits(acfg, n_p, CARD)


def test_grad_norm_summed_in_pieces(monkeypatch):
    """``torch.vdot`` takes at most 2^31 - 1 elements a call, which the
    flat gradient sum of gemma3-train's 2.2B params passes: the train
    step sums the squares a piece of ``VDOT_ELEMS`` at a time. With the
    piece cut to 1000 elements the reduced gemma launcher's gradient
    norms (which the clip reads) and losses over 4 steps equal the
    one-piece run's within fp32 rounding (rtol 1e-5)."""
    from repro_torch.train import step as train_step
    runs = []
    for piece in (train_step.VDOT_ELEMS, 1000):
        monkeypatch.setattr(train_step, "VDOT_ELEMS", piece)
        acfg = launch_train.configure("gemma3-27b", steps=4, reduced=True)
        model = launch_train.make_model(acfg, reduced=True, device="cpu")
        out = []
        launch_train.run(acfg, model, steps=4, log_every=0,
                         on_metrics=lambda t, mt: out.append(
                             (float(mt["loss"]), float(mt["grad_norm"]))))
        runs.append(np.asarray(out))
    assert (runs[0][:, 1] > 0).all()
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_cli_reduced_on_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--reduced", "--steps", "3",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "3 steps in" in out and "batch=8x64" in out


# -- on a card ---------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (these tests run the CUDA kernels)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gemma_super_block_on_card_matches_cpu(cuda):
    """One fp32 gemma super-block (5 window layers and a global one, heads
    of 64 over 2 KV heads, window 64) on 192 tokens: forward and backward,
    a 160-token prefill into fresh rings (they wrap) and one decode step,
    card against CPU within 1e-3 of the CPU tensor's largest magnitude
    (IEEE fp32 sums in other orders), the card twice bit for bit."""
    from repro_torch.core.paths import tree_map
    from repro_torch.models import transformer as tfm
    cfg = reduced(get_config("gemma3-27b").model, d_model=256, n_heads=4,
                  n_kv_heads=2, head_dim=64, d_ff=512, sliding_window=64,
                  dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(3)
    p = tfm._block_init(g, cfg, "gemma", (), cuda)
    p = {"local": tfm._unbind(p["local"], 5), "global": p["global"]}
    x = torch.randn((2, 192, cfg.d_model), generator=g, device=cuda)
    dout = torch.randn(x.shape, generator=g, device=cuda)

    def run(p, x, dout):
        req = {path: t.detach().clone().requires_grad_(True)
               for path, t in leaves_with_paths(p)}
        live = map_with_paths(lambda path, _: req[path], p)
        xr = x.clone().requires_grad_(True)
        pos = torch.arange(192, device=x.device)[None].expand(2, 192)
        out, _, _ = tfm._apply_block("gemma", xr, live, cfg, positions=pos,
                                     cache=None, chunk_k=64)
        (out * dout).sum().backward()
        lm = LanguageModel(dataclasses.replace(cfg, n_layers=6),
                           chunk_k=64, device=x.device)
        fresh = {k: tfm._layer_cache(v, 0) for k, v in
                 lm.init_cache(2, 192)["seg0"].items()}
        with torch.no_grad():
            tfm._apply_block("gemma", x[:, :160], p, cfg,
                             positions=pos[:, :160], cache=fresh, chunk_k=64)
            cache = tfm._advance(fresh, 160)      # written in place
            dec, _, _ = tfm._apply_block(
                "gemma", x[:, 160:161], p, cfg, positions=pos[:, 160:161],
                cache=cache, chunk_k=64)
        return [out.detach(), xr.grad, dec] + [req[k].grad for k in
                                                sorted(req)]
    a, b = run(p, x, dout), run(p, x, dout)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    host = tree_map(lambda t: t.cpu(), p)
    c = run(host, x.cpu(), dout.cpu())
    for u, w in zip(a, c):
        err = float((u.cpu() - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()), err
    _close(a[2][:, 0].cpu(), a[0][:, 160].cpu(),
           1e-3 * float(a[0].abs().max()))


@pytest.mark.gpu
def test_gemma_trainer_graphed_fit_matches_eager(cuda):
    """Reduced Gemma3 (one super-block and a 2-layer local tail, window
    16, heads of 16 on K7's and K7b's sm_80-unit designs) with the
    config's bf16 ring on every param, grad_accum 8 and remat through the
    Trainer: the graphed run's losses and final params equal the eager
    run's bit for bit; K7 twice and K7b once per layer and microbatch."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.paths import leaves_with_paths as lwp
    from repro_torch.kernels import flash_attention as kf
    from repro_torch.train import Trainer
    acfg = get_config("gemma3-27b")
    mc = reduced(acfg.model, n_layers=8, sliding_window=16)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, m=4, s=10, warmup_steps=4,
                                cooldown_steps=2),
        optimizer=dataclasses.replace(acfg.optimizer, warmup_steps=4,
                                      total_steps=24),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=8),
        train=TrainConfig(global_batch=8, seq_len=64))
    runs = {}
    for graphs in (True, False):
        tr = Trainer(LanguageModel(mc, chunk_k=64, remat="block",
                                   device=cuda), acfg, device=cuda,
                     cuda_graphs=graphs)
        losses = []
        for key in kf.LAUNCHES:
            kf.LAUNCHES[key] = 0
        st = tr.fit(synthetic_lm_batches(0, 8, 64, mc.vocab_size,
                                         device=cuda), 22,
                    state=tr.init_state(key=torch.Generator(
                        device=cuda).manual_seed(0)),
                    on_metrics=lambda t, m: losses.append(float(m["loss"])))
        torch.cuda.synchronize()
        assert kf.LAUNCHES["flash_attention"] == 2 * 8 * 8 * 22
        assert kf.LAUNCHES["flash_attention_bwd"] == 8 * 8 * 22
        runs[graphs] = (losses, st, dict(tr.graph_stats))
    (lg, sg, stats), (le, se, _) = runs[True], runs[False]
    assert stats["replayed"] > 0
    assert lg == le and np.isfinite(lg).all()
    for (path, a), (_, b) in zip(lwp(sg.params), lwp(se.params)):
        assert torch.equal(a, b), path
