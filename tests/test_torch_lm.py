"""The port's dense LM (``models/layers.py``, ``attention.py``,
``transformer.py``, ``convert.py``) against the reference on the same
inputs: numpy draws for the layers and the attention cores, and the
reference's own initial weights carried across by ``params_from_jax`` for
the model.

Tolerances: fp32 within 1e-4 absolute on O(1) values (the fp32 noise of
summation order over d <= 128 and 4 layers; measured ~2e-6); the bf16
model within 4e-2 * max(1, max |logits|) (bf16 keeps 8 bits: the two
frameworks round the bf16 residual stream at different places, a few
steps of 2^-8 relative through 4 layers; measured 1.4e-2).
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
from repro_torch.configs import ModelConfig, get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths
from repro_torch.kernels import flash_attention as kf
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import LanguageModel, segment_plan

TOL = 1e-4
BF16_TOL = 4e-2
RNG = np.random.default_rng(0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0, atol=tol)


@functools.lru_cache(maxsize=None)
def _models(dtype="float32"):
    jm = j_reduced(j_get_config("tinyllama-1.1b").model, dtype=dtype)
    tm = reduced(get_config("tinyllama-1.1b").model, dtype=dtype)
    jlm = JLM(jm, head_tp=False, chunk_k=16, scan_layers=False)
    jp = jlm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jlm, jp, LanguageModel(tm, chunk_k=16, device="cpu"), tp


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(
        1, vocab, size=(B, S)).astype(np.int32)


# -- layers -----------------------------------------------------------------

def test_rms_norm_rope_mlp_softcap_match_reference():
    cfg = reduced(get_config("tinyllama-1.1b").model, dtype="float32")
    x = RNG.standard_normal((2, 7, 4, 16), np.float32)
    scale = RNG.standard_normal((16,), np.float32) * 0.1
    _close(tlayers.rms_norm(_t(x), _t(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    np.testing.assert_array_equal(tlayers.rope_freqs(16, 1e4).numpy(),
                                  np.asarray(jlayers.rope_freqs(16, 1e4)))
    pos = np.stack([np.arange(7), np.arange(7) + 30]).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(pos), 1e4),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    h = RNG.standard_normal((2, 5, cfg.d_model), np.float32)
    p = {k: RNG.standard_normal(s, np.float32) / 8 for k, s in
         (("w_in", (64, 128)), ("w_gate", (64, 128)), ("w_out", (128, 64)))}
    _close(tlayers.apply_mlp(_t(h), {k: _t(v) for k, v in p.items()}, cfg),
           jlayers.apply_mlp(jnp.asarray(h), {k: jnp.asarray(v)
                                              for k, v in p.items()}, cfg))
    _close(tlayers.softcap(_t(h * 40), 30.0),
           jlayers.softcap(jnp.asarray(h * 40), 30.0))
    assert tlayers.softcap(_t(h), 0.0) is not None
    # M-RoPE at the reduced sections: three streams that differ, against
    # the reference; (B, S) positions are refused
    streams = np.stack([pos, pos // 2, pos % 5], axis=1).astype(np.int32)
    _close(tlayers.apply_rope(_t(x), _t(streams), 1e4, (2, 3, 3)),
           jlayers.apply_rope(jnp.asarray(x), jnp.asarray(streams), 1e4,
                              (2, 3, 3)))
    with pytest.raises(ValueError, match="M-RoPE"):
        tlayers.apply_rope(_t(x), _t(pos), 1e4, (2, 3, 3))


def test_dense_init_scale_and_dtype():
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(g, (3, 512, 256), torch.bfloat16, "cpu")
    assert w.dtype == torch.bfloat16 and w.shape == (3, 512, 256)
    assert abs(float(w.float().std()) - 512 ** -0.5) < 2e-3


# -- attention cores ---------------------------------------------------------

@pytest.mark.parametrize("Sq,Sk,q_offset,kv_len,causal,window", [
    (37, 37, 0, None, True, 0),        # prefill
    (37, 37, 0, None, False, 0),
    (40, 40, 0, None, True, 8),        # sliding window
    (1, 50, 20, 21, True, 0),          # decode against a longer cache
    (3, 50, 30, 33, True, 0),
    (1, 50, 49, 50, True, 16),
])
def test_blockwise_attention_matches_reference(Sq, Sk, q_offset, kv_len,
                                               causal, window):
    q = RNG.standard_normal((2, Sq, 4, 16), np.float32)
    k = RNG.standard_normal((2, Sk, 2, 16), np.float32)
    v = RNG.standard_normal((2, Sk, 2, 16), np.float32)
    want = jattn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset,
        kv_len=None if kv_len is None else jnp.asarray(kv_len),
        chunk_k=16)
    got = tattn.blockwise_attention(_t(q), _t(k), _t(v), causal=causal,
                                    window=window, q_offset=q_offset,
                                    kv_len=kv_len, chunk_k=16)
    _close(got, want)
    if q_offset == 0 and kv_len is None:       # the K7 route's contract
        _close(kf.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                  window=window), want)


def test_blockwise_attention_per_row_lengths():
    """A (B,) offset/length vector gives each row what a scalar call on
    that row alone gives (the engine's slot table)."""
    q = RNG.standard_normal((3, 1, 4, 16), np.float32)
    k = RNG.standard_normal((3, 40, 2, 16), np.float32)
    v = RNG.standard_normal((3, 40, 2, 16), np.float32)
    lens = [5, 17, 39]
    got = tattn.blockwise_attention(
        _t(q), _t(k), _t(v), causal=True, q_offset=torch.tensor(lens),
        kv_len=torch.tensor(lens) + 1, chunk_k=16)
    for b, n in enumerate(lens):
        want = jattn.blockwise_attention(
            jnp.asarray(q[b:b + 1]), jnp.asarray(k[b:b + 1]),
            jnp.asarray(v[b:b + 1]), causal=True, q_offset=n,
            kv_len=jnp.asarray(n + 1), chunk_k=16)
        _close(got[b:b + 1], want)


# -- the model ---------------------------------------------------------------

def test_param_tree_matches_reference():
    jlm, jp, tlm, tp = _models()
    mine = tlm.init(torch.Generator().manual_seed(1))
    ref = dict(leaves_with_paths(tp))
    got = dict(leaves_with_paths(mine))
    assert sorted(got) == sorted(ref)
    for path, leaf in got.items():
        assert leaf.shape == ref[path].shape and \
            leaf.dtype == ref[path].dtype, path
    assert ref["/seg0/attn/wq"].shape[0] == tlm.cfg.n_layers
    assert tlm.param_count(mine) == jlm.param_count(jp)


def test_params_from_jax_keeps_bf16_and_stacks():
    jlm, jp, _, _ = _models("bfloat16")
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    wq = tp["seg0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.shape[0] == jlm.cfg.n_layers
    np.testing.assert_array_equal(
        wq.float().numpy(), np.asarray(jp["seg0"]["attn"]["wq"], np.float32))
    assert tp["final_norm"]["scale"].dtype == torch.float32


def test_forward_and_loss_match_reference():
    jlm, jp, tlm, tp = _models()
    toks = _tokens(2, 37, tlm.cfg.vocab_size)
    jl, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, aux = tlm.forward(tp, {"tokens": _t(toks)})
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    _close(tl, jl)
    assert float(aux) == 0.0
    jloss, _ = jlm.loss(jp, {"tokens": jnp.asarray(toks)})
    tloss, parts = tlm.loss(tp, {"tokens": _t(toks)})
    _close(tloss, jloss)
    assert float(parts["ce"]) == float(tloss)


def test_padded_vocab_rows_are_masked():
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b").model,
                                      dtype="float32"), vocab_size=500)
    assert cfg.padded_vocab == 512
    lm = LanguageModel(cfg, device="cpu")
    logits, _ = lm.forward(lm.init(), {"tokens": torch.ones((1, 3),
                                                            dtype=torch.long)})
    assert (logits[..., 500:] == -1e30).all()
    assert (logits[..., :500] > -1e29).all()


def test_prefill_and_decode_match_reference():
    jlm, jp, tlm, tp = _models()
    toks = _tokens(2, 21, tlm.cfg.vocab_size, seed=1)
    jc, tc = jlm.init_cache(2, 40), tlm.init_cache(2, 40)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc = tlm.prefill(tp, {"tokens": _t(toks)}, tc)
    _close(tl, jl)
    _close(tc["seg0"].k[:, :, :21], jc["seg0"].k[:, :, :21])
    for _ in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
        jl, jc = jlm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc)
        tl, tc = tlm.decode_step(tp, {"tokens": _t(nxt)}, tc)
        _close(tl, jl)
    assert tc["seg0"].length == int(jc["seg0"].length[0]) == 27


def test_bf16_model_matches_reference():
    jlm, jp, tlm, tp = _models("bfloat16")
    toks = _tokens(2, 37, tlm.cfg.vocab_size)
    jl, _ = jlm.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tlm.forward(tp, {"tokens": _t(toks)})
    scale = max(1.0, float(np.abs(np.asarray(jl)).max()))
    _close(tl, jl, BF16_TOL * scale)
    jc, tc = jlm.init_cache(2, 40), tlm.init_cache(2, 40)
    jl, jc = jlm.prefill(jp, {"tokens": jnp.asarray(toks[:, :20])}, jc)
    tl, tc = tlm.prefill(tp, {"tokens": _t(toks[:, :20])}, tc)
    _close(tl, jl, BF16_TOL * scale)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    jl, _ = jlm.decode_step(jp, {"tokens": jnp.asarray(nxt)}, jc)
    tl, _ = tlm.decode_step(tp, {"tokens": _t(nxt)}, tc)
    _close(tl, jl, BF16_TOL * scale)


# -- what is not ported raises -----------------------------------------------

def test_unported_configs_raise():
    # every architecture of the reference builds: the last two came with
    # the VLM and enc-dec families
    assert [tuple(s) for s in segment_plan(get_config(
        "qwen2-vl-7b").model)] == [("dense", 28)]
    assert [tuple(s) for s in segment_plan(get_config(
        "whisper-base").model)] == [("enc", 6), ("dec", 6)]
    with pytest.raises(KeyError, match="unknown"):
        get_config("no-such-arch")
    for kw in (dict(family="rnn"), dict(family="")):
        with pytest.raises(ValueError, match="unknown family"):
            segment_plan(ModelConfig(**kw))
    with pytest.raises(NotImplementedError, match="eager"):
        LanguageModel(ModelConfig(), scan_layers=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            LanguageModel(ModelConfig())
