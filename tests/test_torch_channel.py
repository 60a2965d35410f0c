"""The port's trainer -> server weights bus (``serve/store.py::
WeightsChannel``) on the CPU, at reduced TinyLlama widths.

  * publish / latest_version / load roundtrip, ``keep=2``;
  * a publisher killed before its rename (a ``.tmp_`` directory, or a
    step directory without its manifest) stays invisible, and the next
    publish lands;
  * ``poll`` swaps an engine onto a newer version once (idempotent);
  * a polled engine serves tokens and last logits equal to an engine
    cold-started on ``load``, both when it polls before its first request
    and when it polls mid-stream (the requests admitted after the swap);
  * the reference's ``WeightsChannel`` publishes LM params (fp32 and
    bf16) and the port loads them into its engine: equal to
    ``params_from_jax`` of the same arrays, and the port's publishes load
    in the reference. The reference's own test trains an LM first; the
    port cannot train an LM yet (K7 has no backward, ROADMAP Queue 1 item
    6), so the params are published directly.
"""
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models.transformer import LanguageModel as JLM
from repro.serve import WeightsChannel as JChannel
from repro_torch.checkpoint import list_checkpoints
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import keystr_leaves, tree_map
from repro_torch.models.transformer import LanguageModel
from repro_torch.serve import ServeConfig, ServeEngine, WeightsChannel

SHRINK = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, n_heads=2,
              n_kv_heads=1, head_dim=16)
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [2, 4], [7] * 8, [3, 1, 4, 1, 5, 9],
           [9, 9], [4, 4, 4]]


@functools.lru_cache(maxsize=None)
def _reference(dtype):
    mc = j_reduced(j_get_config("tinyllama-1.1b").model, dtype=dtype,
                   **SHRINK)
    model = JLM(mc, head_tp=False, chunk_k=16, scan_layers=False)
    return model, jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.PRNGKey(0)))


@functools.lru_cache(maxsize=None)
def _model(dtype="float32"):
    mc = reduced(get_config("tinyllama-1.1b").model, dtype=dtype, **SHRINK)
    return LanguageModel(mc, chunk_k=16, device="cpu")


def _params(seed, dtype="float32"):
    return _model(dtype).init(torch.Generator().manual_seed(seed))


def _equal(a, b):
    la, lb = keystr_leaves(a), keystr_leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y), k


def _engine(params, **kw):
    cfg = dict(n_slots=4, prompt_buckets=(4, 8), batch_buckets=(1, 2),
               max_new_tokens=5)
    cfg.update(kw)
    return ServeEngine(_model(), params, ServeConfig(**cfg))


def test_channel_roundtrip_and_keep_two(tmp_path):
    ch = WeightsChannel(tmp_path)
    assert ch.latest_version() is None
    assert ch.load(_params(0)) is None
    p10, p16, p20 = _params(1), _params(2), _params(3)
    ch.publish(p10, 10)
    assert ch.latest_version() == 10
    _equal(ch.load(_params(0)), p10)
    ch.publish(p16, 16)
    assert ch.latest_version() == 16
    _equal(ch.load(_params(0)), p16)
    _equal(ch.load(_params(0), version=10), p10)
    ch.publish(p20, 20)
    assert list_checkpoints(tmp_path) == [16, 20]
    _equal(ch.load(_params(0)), p20)


def test_torn_publish_is_invisible(tmp_path):
    """A publisher killed before its rename leaves a ``.tmp_`` directory,
    or a step directory without its manifest: neither is a version, and
    the next publish over them lands."""
    ch = WeightsChannel(tmp_path)
    p10 = _params(1)
    ch.publish(p10, 10)
    (tmp_path / ".tmp_dead").mkdir()
    (tmp_path / ".tmp_dead" / "arrays.npz").write_bytes(b"garbage")
    (tmp_path / "step_99").mkdir()
    assert ch.latest_version() == 10
    _equal(ch.load(_params(0)), p10)
    eng = _engine(_params(0))
    assert ch.poll(eng, _params(0)) == 10 and eng.version == 10
    p11 = _params(2)
    ch.publish(p11, 11)
    assert ch.latest_version() == 11
    _equal(ch.load(_params(0)), p11)


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p)
    return {r.uid: r for r in engine.run_until_drained()}


def test_polled_engine_serves_like_a_cold_start(tmp_path):
    """A server that polled the published version serves tokens and last
    logits identical to a server cold-started on ``load``; poll is
    idempotent; version stamps and nothing dropped."""
    ch = WeightsChannel(tmp_path)
    template = _params(0)
    ch.publish(tree_map(lambda t: t * 1.5, _params(1)), 10)
    hot = _engine(template)
    assert ch.poll(hot, template) == 10
    assert ch.poll(hot, template) is None
    assert hot.version == 10
    cold = _engine(ch.load(template))
    rh, rc = _serve(hot, PROMPTS), _serve(cold, PROMPTS)
    assert sorted(rh) == sorted(rc) == list(range(len(PROMPTS)))
    for u in rh:
        assert rh[u].tokens == rc[u].tokens
        np.testing.assert_array_equal(rh[u].last_logits, rc[u].last_logits)
        assert (rh[u].version_start, rh[u].version_end) == (10, 10)
        assert (rc[u].version_start, rc[u].version_end) == (0, 0)
    assert hot.stats["dropped"] == cold.stats["dropped"] == 0


def test_mid_stream_poll_matches_a_cold_start_after_the_swap(tmp_path):
    """A running engine polls after its second step, with requests in
    flight and queued: the in-flight ones finish on the new version, the
    queued ones are admitted after the swap, and those serve what an
    engine cold-started on the loaded params serves, bit for bit (same
    admission pattern: every request wants the same token count)."""
    ch = WeightsChannel(tmp_path)
    template = _params(0)
    ch.publish(tree_map(lambda t: t * 1.5, _params(1)), 7)
    hot = _engine(template)
    for p in PROMPTS:
        hot.submit(p)
    done = hot.step() + hot.step()
    assert hot.queue_len > 0 and hot.active_slots > 0
    assert ch.poll(hot, template) == 7
    done += hot.run_until_drained()
    rh = {r.uid: r for r in done}
    rc = _serve(_engine(ch.load(template)), PROMPTS)
    after = [u for u, r in rh.items() if r.version_start == 7]
    during = [u for u, r in rh.items() if r.version_start == 0]
    assert after and during
    for u in during:
        assert rh[u].version_end == 7
    for u in after:
        assert rh[u].tokens == rc[u].tokens
        np.testing.assert_array_equal(rh[u].last_logits, rc[u].last_logits)
    assert hot.stats["dropped"] == 0 and hot.stats["swaps"] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_publishes_and_the_port_loads(tmp_path, dtype):
    """The reference's channel publishes its LM params; the port loads
    them into its engine's layout equal to ``params_from_jax`` of the same
    arrays (bf16 bits included) and serves them; the port's publish of
    those params loads in the reference to the same arrays."""
    _, jp = _reference(dtype)
    JChannel(tmp_path / "ref").publish(
        jax.tree_util.tree_map(jax.numpy.asarray, jp), 5)
    ch = WeightsChannel(tmp_path / "ref")
    template = _params(0, dtype)
    got = ch.load(template)
    _equal(got, params_from_jax(jp, device="cpu"))
    eng = ServeEngine(_model(dtype), template, ServeConfig(
        n_slots=2, prompt_buckets=(4, 8), batch_buckets=(1, 2),
        max_new_tokens=3))
    assert ch.poll(eng, template) == 5
    res = _serve(eng, PROMPTS[:3])
    assert all(len(r.tokens) == 3 and r.version_start == 5
               for r in res.values())

    WeightsChannel(tmp_path / "port").publish(got, 6)
    back = JChannel(tmp_path / "port").load(
        jax.tree_util.tree_map(np.zeros_like, jp))
    flat_b = jax.tree_util.tree_leaves(back)
    flat_j = jax.tree_util.tree_leaves(jp)
    assert len(flat_b) == len(flat_j)
    for x, y in zip(flat_b, flat_j):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x).view(np.uint8),
                                      np.asarray(y).view(np.uint8))
