"""The last two architectures (``configs/{qwen2_vl_7b,whisper_base}.py``;
LayerNorm and M-RoPE in ``models/layers.py``; cross-attention in
``models/attention.py``; the ``vlm`` family and the ``enc`` / ``dec``
segments of ``models/transformer.py``) against the reference on the CPU.

  * The mirrored configs field for field, and their reduced forms.
  * M-RoPE against ``repro.models.layers.apply_rope`` with (t, h, w)
    streams that differ, and equal to RoPE where they are equal;
    LayerNorm against ``layer_norm``; ``attend`` with ``kv_override``
    (Sq != Sk, in context and in a decode step) against the reference's.
  * Reduced Qwen2-VL (an image block of 2 x 3 patches, then text whose
    positions continue from the grid's maximum) and reduced Whisper (2
    encoder and 4 decoder layers over 32 stub frames): the param tree,
    ``param_stack_dims``, ``forward`` / ``loss`` / every gradient, remat
    bit for bit, and ``prefill`` / ``decode_step`` with their caches, on
    the reference's own weights carried by ``params_from_jax``.
  * The full-size meta init against the reference's abstract init; the
    dec cache's two cross tensors; the engine refusing both models, as
    the reference's does.
  * Each reduced launcher through a DMD jump against
    ``repro.train.Trainer``; ``check_fits`` by depth; the Trainer's gate
    batch carrying the stream's M-RoPE positions and frames.
  * On a card (marker ``gpu``): a Qwen2-VL block card against CPU, and a
    reduced Whisper Trainer graphed = eager.

Tolerances (fp32): layer functions within 1e-5 absolute on O(1) values;
the models within 1e-4 (test_torch_lm.py's rule), gradients within 1e-4 *
max(1, their largest magnitude); the Trainers' losses to rtol 1e-5 until
the first jump and 2e-3 on the jump step (test_torch_lm_train.py's rule).
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
from repro_torch.data.tokens import (image_positions, stream_kwargs,
                                     synthetic_lm_batches)
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import (LanguageModel, cache_length,
                                            init_params, segment_plan)
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import Trainer

LAYER_TOL = 1e-5
TOL = 1e-4
ARCHS = ("qwen2-vl-7b", "whisper-base")
# the reduced models: vocab 100 pads to 112 (the head masks the pad
# columns); whisper with the reference's reduced encoder (2 layers over 32
# frames)
SHRINK = dict(vocab_size=100, dtype="float32")
# the reference's abstract init's counts, summed in Python integers (its
# LanguageModel.param_count multiplies each leaf's shape in int32: no leaf
# of these two passes 2^31, so it agrees)
FULL = {"qwen2-vl-7b": 7_615_487_488, "whisper-base": 88_175_616}
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


def _image_positions(B, S, grid=(2, 3), start=0):
    """Qwen2-VL's (B, 3, S) position streams (``data/tokens.py``'s
    ``image_positions``) as numpy."""
    return image_positions(B, S, grid, start, device="cpu").numpy()


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_reduced_mirror_reference(arch):
    jc, tc = j_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(n_layers=3, d_model=32), dict(dtype="float32")):
        assert dataclasses.asdict(tbase.reduced(tc.model, **kw)) == \
            dataclasses.asdict(j_reduced(jc.model, **kw))
    assert tc.model.padded_vocab == jc.model.padded_vocab
    assert [tuple(s) for s in segment_plan(tc.model)] == \
        [tuple(s) for s in JLM(jc.model).plan]
    if arch == "whisper-base":
        assert tc.model.padded_vocab == 51872
        assert [tuple(s) for s in segment_plan(tc.model)] == \
            [("enc", 6), ("dec", 6)]
    else:
        assert [tuple(s) for s in segment_plan(tc.model)] == [("dense", 28)]


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("streams", ["differ", "equal"])
def test_mrope_matches_reference(streams):
    """M-RoPE at qwen2-vl's sections (16, 24, 24) of hd/2 = 64 against the
    reference, the (t, h, w) streams of an image block then text; with
    three equal streams it is RoPE, in both packages."""
    B, S, H, hd = 2, 19, 3, 128
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, H, hd), np.float32)
    sections = get_config("qwen2-vl-7b").model.mrope_sections
    pos = _image_positions(B, S, grid=(3, 4), start=5)
    if streams == "equal":
        pos = np.broadcast_to(pos[:, :1], pos.shape).copy()
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                              sections)
    got = tlayers.apply_rope(_t(x), _t(pos), 1e6, sections)
    _close(got, want, LAYER_TOL)
    rope = tlayers.apply_rope(_t(x), _t(pos[:, 0]), 1e6)
    if streams == "equal":
        assert torch.equal(got, rope)
        assert torch.equal(tlayers.apply_rope(_t(x), _t(pos), 1e6), rope)
    else:
        assert float((got - rope).abs().max()) > 0.1
    with pytest.raises(ValueError, match="3, S"):
        tlayers.apply_rope(_t(x), _t(pos[:, 0]), 1e6, sections)
    with pytest.raises(ValueError, match="cover"):
        tlayers.apply_rope(_t(x), _t(pos), 1e6, (16, 24, 16))


def test_layer_norm_matches_reference():
    cfg = get_config("whisper-base").model
    p = tlayers.norm_init(cfg, "cpu", (2,))
    assert sorted(p) == ["b", "scale"] and p["scale"].shape == (2, 512)
    assert bool((p["scale"] == 1).all()) and bool((p["b"] == 0).all())
    assert p["b"].dtype == p["scale"].dtype == torch.float32
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 512), np.float32) * 3 + 1
    scale = rng.standard_normal(512).astype(np.float32)
    bias = rng.standard_normal(512).astype(np.float32)
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias))
    got = tlayers.apply_norm(_t(x), {"scale": _t(scale), "b": _t(bias)},
                             cfg)
    _close(got, want, LAYER_TOL)
    # bf16 in, the math in fp32, bf16 out
    xb = _t(x).bfloat16()
    out = tlayers.layer_norm(xb, _t(scale), _t(bias))
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, tlayers.layer_norm(xb.float(), _t(scale),
                                               _t(bias)).bfloat16())


@pytest.mark.parametrize("decode", [False, True])
def test_cross_attention_matches_reference(decode):
    """``attend`` with ``kv_override``: 5 queries (1 in a decode step)
    over 23 keys, non-causal, no rope, no cache write; in context through
    K7's twin, in a decode step through the plain core."""
    jc = j_reduced(j_get_config("whisper-base").model, dtype="float32")
    tc = reduced(get_config("whisper-base").model, dtype="float32")
    jp = jax.tree_util.tree_map(np.asarray, jattn.attn_init(
        jax.random.PRNGKey(6), jc))
    tp = params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(3)
    Sq, Sk = (1, 23) if decode else (5, 23)
    x = rng.standard_normal((2, Sq, tc.d_model), np.float32)
    k, v = (rng.standard_normal((2, Sk, tc.n_kv_heads, tc.head_dim),
                                np.float32) for _ in range(2))
    pos = np.broadcast_to(np.arange(Sq) + 40, (2, Sq))
    want, _ = jattn.attend(jnp.asarray(x), jp, jc, positions=jnp.asarray(
        pos), use_rope=False, kv_override=(jnp.asarray(k), jnp.asarray(v)),
        head_tp=False, chunk_k=8)
    got, cache = tattn.attend(_t(x), tp, tc, positions=_t(pos),
                              use_rope=False, kv_override=(_t(k), _t(v)),
                              chunk_k=8)
    assert cache is None
    _close(got, want, LAYER_TOL)


# -- the models --------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(arch):
    jm = j_reduced(j_get_config(arch).model, **SHRINK)
    tm = reduced(get_config(arch).model, **SHRINK)
    jlm = JLM(jm, head_tp=False, chunk_k=16, scan_layers=False)
    jp = jax.jit(jlm.init)(jax.random.PRNGKey(0))
    return jlm, jp, LanguageModel(tm, chunk_k=16, device="cpu"), \
        params_from_jax(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _jitted(arch):
    jlm = _models(arch)[0]
    return {"forward": jax.jit(jlm.forward),
            "loss": jax.jit(jax.value_and_grad(
                lambda p, b: jlm.loss(p, b)[0])),
            "prefill": jax.jit(jlm.prefill),
            "decode": jax.jit(jlm.decode_step)}


def _batch(arch, B, S, seed=0):
    """numpy batch: tokens, and qwen2-vl's image positions or whisper's
    frames."""
    cfg = _models(arch)[2].cfg
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(1, SHRINK["vocab_size"], size=(B, S))
             .astype(np.int32)}
    if cfg.mrope_sections:
        batch["positions"] = _image_positions(B, S)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
    return batch


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_and_stack_dims_match_reference(arch):
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
    dims = tlm.param_stack_dims()
    if arch == "whisper-base":
        cfg = tlm.cfg
        assert got["/pos_emb"].shape == (cfg.max_seq_len, cfg.d_model)
        assert got["/enc_pos_emb"].shape == (cfg.encoder_seq_len,
                                             cfg.d_model)
        assert dims["pos_emb"] == dims["enc_pos_emb"] == 0
        assert sorted(mine["seg1"]) == ["cross_attn", "ln1", "ln2", "ln_x",
                                        "mlp", "self_attn"]
        assert dims["seg0"]["attn"]["wq"] == dims["seg1"]["ln_x"]["b"] == 1
        assert got["/seg1/cross_attn/wk"].shape[0] == cfg.n_layers
        assert got["/seg0/mlp/w_in"].shape[0] == cfg.n_encoder_layers
        assert "w_gate" not in mine["seg1"]["mlp"]
    else:
        assert "pos_emb" not in mine and dims["seg0"]["attn"]["wq"] == 1


@pytest.mark.parametrize("arch", ARCHS)
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
    assert launch_train.param_count(LanguageModel(tc, device="cpu")) == \
        FULL[arch] == JLM(jc).param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_reference(arch):
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    batch = _batch(arch, 2, 24, seed=1)
    jl, _ = jf["forward"](jp, _jb(batch))
    tl, aux = tlm.forward(tp, _tb(batch))
    _close(tl, jl, TOL)
    assert float(aux) == 0.0
    assert bool((tl[..., tlm.cfg.vocab_size:] == -1e30).all())
    jloss, jgrads = jf["loss"](jp, _jb(batch))
    leaves = leaves_with_paths(tp)
    req = [x.clone().requires_grad_(True) for _, x in leaves]
    by = {p: r for (p, _), r in zip(leaves, req)}
    rm = LanguageModel(tlm.cfg, chunk_k=16, remat="block", device="cpu")
    losses, grads = [], []
    for model in (tlm, rm):
        loss = model.loss(map_with_paths(lambda p, _: by[p], tp),
                          _tb(batch))[0]
        losses.append(loss)
        grads.append(torch.autograd.grad(loss, req))
    _close(losses[0], jloss, TOL)
    # remat recomputes each super-block (the encoder's too) with the same
    # arithmetic
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    want = dict(leaves_with_paths(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")))
    for (path, _), g in zip(leaves, grads[0]):
        scale = max(1.0, float(np.abs(np.asarray(want[path])).max()))
        assert np.abs(g.numpy() - np.asarray(want[path])).max() <= \
            TOL * scale, (path, scale)
        # the pos_emb rows past the sequence get no gradient
        assert bool(g.abs().max() > 0) or path in ("/emb", "/pos_emb") or \
            "final_norm" in path, path
    if arch == "qwen2-vl-7b":
        # the image block's streams matter: arange positions give another
        # model output
        plain = {k: v for k, v in _tb(batch).items() if k != "positions"}
        assert float((tlm.forward(tp, plain)[0] - tl).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    """A 13-token prompt (qwen2-vl: after a 2 x 3 image block; whisper:
    over its 32 frames), then 6 decode steps (qwen2-vl's positions
    continuing from the prompt's last, whisper's from the cache length):
    logits, cache lengths and the caches' contents."""
    jlm, jp, tlm, tp = _models(arch)
    jf = _jitted(arch)
    batch = _batch(arch, 2, 13, seed=2)
    jc, tc = jlm.init_cache(2, 24), tlm.init_cache(2, 24)
    jl, jc = jf["prefill"](jp, _jb(batch), jc)
    tl, tc = tlm.prefill(tp, _tb(batch), tc)
    _close(tl, jl, TOL)
    nxt_pos = int(batch["positions"].max()) + 1 if "positions" in batch \
        else None
    first = None
    for i in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        step = {"tokens": nxt}
        if nxt_pos is not None:
            step["positions"] = np.full((2, 3, 1), nxt_pos + i, np.int32)
        jl, jc = jf["decode"](jp, _jb(step), jc)
        tl, tc = tlm.decode_step(tp, _tb(step), tc)
        _close(tl, jl, TOL)
        first = tl if first is None else first
    assert cache_length(tc) == 19
    if arch == "whisper-base":
        assert "seg0" not in tc and sorted(tc["seg1"]) == [
            "cross_k", "cross_v", "self"]
        for name in ("cross_k", "cross_v"):
            _close(tc["seg1"][name], jc["seg1"][name], TOL)
        _close(tc["seg1"]["self"].k[:, :, :19],
               jc["seg1"]["self"].k[:, :, :19], TOL)
    else:
        _close(tc["seg0"].k[:, :, :19], jc["seg0"].k[:, :, :19], TOL)
        # the first decode step at the cache length's positions (13, not
        # the grid's continuation, 10) is another step
        lc = tlm.init_cache(2, 24)
        tl, lc = tlm.prefill(tp, _tb(batch), lc)
        nxt = tl[:, -1].argmax(-1)[:, None]
        off, _ = tlm.decode_step(tp, {"tokens": nxt}, lc)
        assert float((off - first).abs().max()) > 1e-3


def attn_at(cache, n):
    """A KVCache's tensors at length n (a prefill wrote them in place)."""
    return tattn.KVCache(cache.k, cache.v, n)


def test_cross_caches_do_not_alias():
    """The reference hands one zeros array to both cross_k and cross_v
    (its stacks then copy it); the port writes caches in place, so they
    are two tensors from the start, and a prefill writes each its own
    values."""
    jlm, jp, tlm, tp = _models("whisper-base")
    caches = tlm.init_cache(2, 16)["seg1"]
    ck, cv = caches["cross_k"], caches["cross_v"]
    assert ck.shape == (tlm.cfg.n_layers, 2, tlm.cfg.encoder_seq_len,
                        tlm.cfg.n_kv_heads, tlm.cfg.head_dim)
    assert ck.untyped_storage().data_ptr() != \
        cv.untyped_storage().data_ptr()
    caches = tlm.init_cache(2, 16)
    tlm.prefill(tp, _tb(_batch("whisper-base", 2, 5, seed=4)), caches)
    ck, cv = caches["seg1"]["cross_k"], caches["seg1"]["cross_v"]
    assert float(ck.abs().max()) > 0 and float((ck - cv).abs().max()) > 0


# -- the engine ------------------------------------------------------------------

ENGINE = dict(n_slots=4, prompt_buckets=(4, 8), batch_buckets=(1, 2),
              max_new_tokens=5)


@pytest.mark.parametrize("arch,match", [
    ("qwen2-vl-7b", "mrope"), ("whisper-base", "segment kinds")])
def test_engine_refuses_as_the_reference_does(arch, match):
    jlm, jp, tlm, tp = _models(arch)
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(tlm, tp, ServeConfig(**ENGINE))
    with pytest.raises(NotImplementedError, match=match):
        JEngine(jlm, jp, JServeConfig(**ENGINE))
    with pytest.raises(NotImplementedError, match=match):
        launch_serve.build(arch, use_reduced=True, device="cpu")
    # they generate through prefill / decode_step on the launcher's draw
    model, params = launch_serve.model_and_params(arch, use_reduced=True,
                                                  device="cpu")
    assert model.param_count(params) == launch_train.param_count(model)


# -- training ----------------------------------------------------------------------

# warm-up 8 (steps // 4) and the configs' cool-down of 10: the first jump
# at 27 (qwen2-vl's m of 10) and 31 (whisper's m of 14)
STEPS = 32


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
    """The launcher's ``run`` on the reduced config (fp32; the config's
    DMD on every param: qwen2-vl's bf16 ring of 10, whisper's fp32 ring
    of 14) on the stream with its M-RoPE positions or frames, against
    ``repro.train.Trainer`` from the same injected init on the same
    batches, the reference's model built as its launcher builds it
    (pad_heads_to 16)."""
    acfg = launch_train.configure(arch, steps=STEPS, reduced=True)
    acfg = dataclasses.replace(acfg, model=dataclasses.replace(
        acfg.model, dtype="float32"))
    m, ring = (10, "bfloat16") if arch == "qwen2-vl-7b" else (14, "float32")
    assert (acfg.dmd.m, acfg.dmd.snapshot_dtype, acfg.dmd.warmup_steps) == \
        (m, ring, STEPS // 4)
    jac = _ref_acfg(arch)
    jlm = JLM(jac.model, head_tp=False, chunk_k=64,
              pad_heads_to=jac.parallel.pad_attn_heads_to)
    jp = jlm.init(jax.random.PRNGKey(0))
    kw = stream_kwargs(acfg.model)
    assert kw == {"mrope": arch == "qwen2-vl-7b",
                  "frames": (32, 64) if arch == "whisper-base" else None}

    ref_losses, ref_jumps = [], []
    jtr = JTrainer(jlm, jac)
    st = jtr.init_state()
    st = st._replace(params=jp, opt_state=jtr.opt.init(jp))
    j_final = jtr.fit(
        ({k: jnp.asarray(v.numpy()) for k, v in b.items()}
         for b in synthetic_lm_batches(0, 8, 64, jac.model.vocab_size,
                                       device="cpu", **kw)), STEPS,
        state=st,
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
    buckets = trainer.acc.arena_for(state.params)
    refs = jtr.acc.arena_for(j_final.params)
    assert sorted(buckets) == sorted(refs)
    for key, b in buckets.items():
        r = refs[key]
        assert (b.m, b.n_sys, b.n_blocks) == (r.m, r.n_sys, r.n_blocks), key
        assert b.m == m


@pytest.mark.parametrize("arch,full,cut,per", [
    ("qwen2-vl-7b", 28, 4, 36), ("whisper-base", 6, 238, 72)])
def test_check_fits_by_depth(arch, full, cut, per):
    """The state's bytes a param (bf16 params, adamw's fp32 moments, the
    fp32 sum and bf16 gradient, the ring: qwen2-vl's bf16 ring of 10,
    whisper's fp32 ring of 14). Qwen2-VL's full depth (274 GB) exceeds
    90% of an 80 GB H100, Whisper's (6.35 GB) does not; `cut` is the
    deepest depth admitted (decoder layers for whisper), one more is
    refused."""
    cases = [(cut, True), (cut + 1, False)]
    cases.append((full, arch == "whisper-base"))
    for n, ok in cases:
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
    acfg = launch_train.configure(arch, steps=100)
    n_p = launch_train.param_count(launch_train.make_model(acfg,
                                                           device="cpu"))
    assert n_p == FULL[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_gate_batch_carries_the_streams(arch):
    """The Trainer's gate batch (the controller's validation split) is
    shaped like a training batch of the full config: Qwen2-VL's (B, 3, S)
    M-RoPE positions, Whisper's (B, 1500, 512) frames, as the reference's
    ``_carve_val_batch`` passes them."""
    acfg = get_config(arch)
    acfg = dataclasses.replace(
        acfg, dmd=dataclasses.replace(acfg.dmd, controller=dataclasses.replace(
            acfg.dmd.controller, enabled=True)),
        train=dataclasses.replace(acfg.train, global_batch=2, seq_len=16))
    tr = Trainer(LanguageModel(acfg.model, device="cpu"), acfg, device="cpu")
    gate = tr.val_batch
    assert gate["tokens"].shape == (2, 16)
    if arch == "whisper-base":
        assert gate["frames"].shape == (2, 1500, 512)
        assert gate["frames"].dtype == torch.float32
        assert "positions" not in gate
    else:
        assert gate["positions"].shape == (2, 3, 16)
        assert "frames" not in gate
    assert sorted(gate) == sorted(
        k for k in ("tokens", "labels", "positions", "frames")
        if k in gate)


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
def test_qwen2_vl_block_on_card_matches_cpu(cuda):
    """One fp32 Qwen2-VL dense block (heads of 128, GQA rep 7 as the
    config's 28 / 4, M-RoPE sections (16, 24, 24), d 512) on 160 tokens
    under an image block's streams: forward and backward, a 128-token
    prefill and one decode step, card against CPU within 1e-3 of the CPU
    tensor's largest magnitude, the card twice bit for bit."""
    from repro_torch.core.paths import tree_map
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(get_config("qwen2-vl-7b").model, d_model=512,
                              n_heads=7, n_kv_heads=1, d_ff=1024,
                              dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(3)
    p = tfm._block_init(g, cfg, "dense", (), cuda)
    x = torch.randn((2, 160, cfg.d_model), generator=g, device=cuda)
    dout = torch.randn(x.shape, generator=g, device=cuda)
    pos_np = _image_positions(2, 160, grid=(4, 6), start=3)

    def run(p, x, dout):
        req = {path: t.detach().clone().requires_grad_(True)
               for path, t in leaves_with_paths(p)}
        live = map_with_paths(lambda path, _: req[path], p)
        xr = x.clone().requires_grad_(True)
        pos = _t(pos_np).to(x.device)
        out, _, _ = tfm._apply_block("dense", xr, live, cfg, positions=pos,
                                     cache=None, chunk_k=64)
        (out * dout).sum().backward()
        cache = tattn.init_kv_cache(2, 160, cfg.n_kv_heads, cfg.head_dim,
                                    torch.float32, x.device)
        with torch.no_grad():
            tfm._apply_block("dense", x[:, :128], p, cfg,
                             positions=pos[..., :128], cache=cache,
                             chunk_k=64)
            dec, _, _ = tfm._apply_block(
                "dense", x[:, 128:129], p, cfg, positions=pos[..., 128:129],
                cache=attn_at(cache, 128), chunk_k=64)
        return [out.detach(), xr.grad, dec] + [req[k].grad for k in
                                                sorted(req)]
    a, b = run(p, x, dout), run(p, x, dout)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    c = run(tree_map(lambda t: t.cpu(), p), x.cpu(), dout.cpu())
    for u, w in zip(a, c):
        err = float((u.cpu() - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()), err
    _close(a[2][:, 0].cpu(), a[0][:, 128].cpu(),
           1e-3 * float(a[0].abs().max()))


@pytest.mark.gpu
def test_whisper_trainer_graphed_fit_matches_eager(cuda):
    """Reduced Whisper (2 encoder and 4 decoder layers, heads of 16 on
    K7's and K7b's sm_80-unit designs) with the config's fp32 ring on
    every param and 2 microbatches through the Trainer, on the stream's
    frames: the graphed run's losses and final params equal the eager
    run's bit for bit; K7 and K7b once per attention and microbatch (2
    encoder, 4 self, 4 cross: no remat)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.paths import leaves_with_paths as lwp
    from repro_torch.kernels import flash_attention as kf
    acfg = get_config("whisper-base")
    mc = reduced(acfg.model)
    acfg = dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, m=4, s=10, warmup_steps=4,
                                cooldown_steps=2),
        optimizer=dataclasses.replace(acfg.optimizer, warmup_steps=4,
                                      total_steps=24),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=2),
        train=TrainConfig(global_batch=4, seq_len=64))
    runs = {}
    for graphs in (True, False):
        tr = Trainer(LanguageModel(mc, chunk_k=64, device=cuda), acfg,
                     device=cuda, cuda_graphs=graphs)
        losses = []
        for key in kf.LAUNCHES:
            kf.LAUNCHES[key] = 0
        st = tr.fit(synthetic_lm_batches(0, 4, 64, mc.vocab_size,
                                         device=cuda, **stream_kwargs(mc)),
                    22, state=tr.init_state(key=torch.Generator(
                        device=cuda).manual_seed(0)),
                    on_metrics=lambda t, m: losses.append(float(m["loss"])))
        torch.cuda.synchronize()
        assert kf.LAUNCHES["flash_attention"] == 10 * 2 * 22
        assert kf.LAUNCHES["flash_attention_bwd"] == 10 * 2 * 22
        runs[graphs] = (losses, st, dict(tr.graph_stats))
    (lg, sg, stats), (le, se, _) = runs[True], runs[False]
    assert stats["replayed"] > 0
    assert lg == le and np.isfinite(lg).all()
    for (path, a), (_, b) in zip(lwp(sg.params), lwp(se.params)):
        assert torch.equal(a, b), path
