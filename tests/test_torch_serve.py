"""The port's serving engine (``serve/engine.py``, ``serve/store.py``,
``launch/serve.py``) on the CPU.

  * Bucketed, padded prompts are bit-exact in their greedy tokens against
    the port's exact-length prefill + decode loop, also with batched
    admission and filler rows into a live slot table (the reference's
    tests/test_serve_engine.py pins, restated for the port).
  * The greedy tokens equal the reference ``ServeEngine``'s for the same
    prompts on the same fp32 reduced weights.
  * Hot-swap: a swapped-in version serves what a cold start on it serves;
    ``adopt="step"`` and ``"drain"``; stale versions are refused.
  * Submit validation, and what the engine does not serve raises.
  * The MoE family: the greedy tokens equal the reference ``ServeEngine``'s
    on reduced Qwen3 and Llama4 (the moe_pair's cache pair); the served
    weights exist once (the store takes the caller's tensors); the
    launcher on the CPU.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.models.transformer import LanguageModel as JLM
from repro.serve import ServeConfig as JServeConfig, ServeEngine as JEngine
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths, tree_map
from repro_torch.launch import serve as launch_serve
from repro_torch.models.transformer import LanguageModel, Segment
from repro_torch.serve import ParamStore, ServeConfig, ServeEngine

PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9], [2, 4], [7] * 8, [3, 1, 4, 1, 5, 9]]
SHRINK = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, n_heads=2,
              n_kv_heads=1, head_dim=16, dtype="float32")


@functools.lru_cache(maxsize=None)
def _reference():
    mc = j_reduced(j_get_config("tinyllama-1.1b").model, **SHRINK)
    model = JLM(mc, head_tp=False, chunk_k=16, scan_layers=False)
    return model, model.init(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _model_and_params():
    _, jp = _reference()
    mc = reduced(get_config("tinyllama-1.1b").model, **SHRINK)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return LanguageModel(mc, chunk_k=16, device="cpu"), params


def _cfg(**kw):
    kw.setdefault("n_slots", 4)
    kw.setdefault("prompt_buckets", (4, 8))
    kw.setdefault("batch_buckets", (1, 2))
    kw.setdefault("max_new_tokens", 5)
    return kw


def _engine(params=None, **kw):
    model, p0 = _model_and_params()
    return ServeEngine(model, p0 if params is None else params,
                       ServeConfig(**_cfg(**kw)))


def _greedy(prompt, n_new, params=None):
    model, p0 = _model_and_params()
    return launch_serve.exact_greedy(model, p0 if params is None else params,
                                     prompt, n_new)[0]


def _bumped():
    return tree_map(lambda t: t * 1.5, _model_and_params()[1])


def test_engine_matches_exact_length_loop():
    eng = _engine()
    for p in PROMPTS:
        eng.submit(p)
    res = {r.uid: r for r in eng.run_until_drained()}
    assert len(res) == len(PROMPTS)
    for i, p in enumerate(PROMPTS):
        assert res[i].tokens == _greedy(p, 5), (i, p)
        assert res[i].prompt_len == len(p)
        assert res[i].last_logits.shape == (128,)
    assert eng.stats["dropped"] == 0
    assert eng.stats["tokens_emitted"] == 5 * len(PROMPTS)


def test_engine_tokens_equal_the_reference_engine():
    jmodel, jp = _reference()
    jeng = JEngine(jmodel, jp, JServeConfig(**_cfg()))
    eng = _engine()
    for p in PROMPTS:
        jeng.submit(p)
        eng.submit(p)
    want = {r.uid: r.tokens for r in jeng.run_until_drained()}
    got = {r.uid: r.tokens for r in eng.run_until_drained()}
    assert got == want
    assert eng.stats["decode_dispatches"] == jeng.stats["decode_dispatches"]
    assert eng.stats["prefill_dispatches"] == \
        jeng.stats["prefill_dispatches"]


def test_batched_admission_preserves_live_slots():
    """A batch bucket of 4 with 3 requests: the filler row carries the
    sentinel slot and clobbers neither free slots nor live requests."""
    eng = _engine(n_slots=8, batch_buckets=(1, 2, 4))
    for p in ([1, 2, 3], [2, 4], [3, 3, 3, 1]):
        eng.submit(p)
    eng.step()                                        # Bb=4 + filler row
    assert eng.stats["prefill_dispatches"] == 1
    assert eng.active_slots == 3
    eng.submit([9, 9, 9])                             # admit mid-flight
    res = {r.uid: r.tokens for r in eng.run_until_drained()}
    for i, p in enumerate([[1, 2, 3], [2, 4], [3, 3, 3, 1], [9, 9, 9]]):
        assert res[i] == _greedy(p, 5), (i, p)


def test_one_decode_per_token_step():
    eng = _engine()
    eng.submit([1, 2, 3])
    eng.run_until_drained()
    assert eng.stats["decode_dispatches"] == 5
    assert eng.stats["prefill_dispatches"] == 1
    eng.submit([4, 5])
    eng.submit([6, 7, 8])
    eng.run_until_drained()
    assert eng.stats["decode_dispatches"] == 10
    assert eng.stats["tokens_emitted"] == 15


def test_topk_sampling_is_seeded():
    kw = dict(sampling="topk", top_k=4, seed=11)
    a, b, c = _engine(**kw), _engine(**kw), _engine(**dict(kw, seed=12))
    for e in (a, b, c):
        e.submit([1, 2, 3])
        e.submit([4, 5])
    ra = {r.uid: r.tokens for r in a.run_until_drained()}
    rb = {r.uid: r.tokens for r in b.run_until_drained()}
    rc = {r.uid: r.tokens for r in c.run_until_drained()}
    assert ra == rb and ra != rc
    assert all(len(t) == 5 for t in ra.values())


def test_swap_is_bit_exact_vs_cold_start():
    model, _ = _model_and_params()
    bumped = _bumped()
    hot = _engine()
    hot.submit([1, 2, 3])
    hot.run_until_drained()                       # serve v0 first
    assert hot.swap_weights(bumped, version=7) == 7
    assert hot.version == 7
    cold = _engine(params=bumped)
    for p in PROMPTS[:3]:
        hot.submit(p)
        cold.submit(p)
    rh = {r.uid: r for r in hot.run_until_drained()}
    rc = {r.uid: r for r in cold.run_until_drained()}
    for uh, uc in zip(sorted(rh), sorted(rc)):
        assert rh[uh].tokens == rc[uc].tokens
        np.testing.assert_array_equal(rh[uh].last_logits,
                                      rc[uc].last_logits)
        assert (rh[uh].version_start, rh[uh].version_end) == (7, 7)


def test_step_adopt_swaps_in_flight_requests():
    eng = _engine(adopt="step", max_new_tokens=6)
    eng.submit([1, 2, 3])
    eng.step()
    eng.step()                                    # 2 of 6 tokens on v0
    eng.swap_weights(_bumped(), version=3)
    (res,) = eng.run_until_drained()
    assert (res.version_start, res.version_end) == (0, 3)
    assert eng.stats["swaps"] == 1


def test_drain_adopt_holds_until_table_empties():
    bumped = _bumped()
    eng = _engine(adopt="drain", max_new_tokens=4)
    eng.submit([1, 2, 3])
    eng.step()
    eng.swap_weights(bumped, version=3)
    assert eng.version == 0                       # active slot: no adopt
    eng.submit([4, 5])                            # held while pending
    res = {r.uid: r for r in eng.run_until_drained()}
    assert (res[0].version_start, res[0].version_end) == (0, 0)
    assert (res[1].version_start, res[1].version_end) == (3, 3)
    assert eng.version == 3
    assert res[1].tokens == _greedy([4, 5], 4, params=bumped)


def test_param_store_versions_and_copies():
    params = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    # the store serves the tensors it is given: a caller that goes on
    # changing its own passes a clone
    store = ParamStore(tree_map(torch.clone, params))
    assert store.version == 0
    params["a"].add_(1)                           # the caller's tensors
    assert float(store.params["a"][0]) == 1.0     # not the store's
    assert store.stage(params) == 1 and store.version == 0
    assert store.staged_version == 1
    params["a"].add_(1)                           # stage landed a copy
    assert store.commit() == 1 and float(store.params["a"][0]) == 2.0
    with pytest.raises(ValueError, match="stale"):
        store.stage(params, version=1)
    with pytest.raises(RuntimeError, match="no staged"):
        store.commit()
    assert store.publish(params, version=5) == 5


def test_submit_validation():
    eng = _engine()
    with pytest.raises(ValueError, match="exceeds the largest"):
        eng.submit(list(range(20)))
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit([1, 2], max_new_tokens=99)
    with pytest.raises(ValueError, match="stale publish"):
        eng.swap_weights(_model_and_params()[1], version=0)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(prompt_buckets=(8, 4)), ValueError, "ascending"),
    (dict(batch_buckets=(1, 8)), ValueError, "n_slots"),
    (dict(sampling="beam"), ValueError, "sampling"),
    (dict(adopt="never"), ValueError, "adopt"),
    (dict(s_max=6), ValueError, "s_max"),
])
def test_config_validation(kw, exc, match):
    with pytest.raises(exc, match=match):
        _engine(**kw)


def test_unsupported_families_fail_loudly():
    model, params = _model_and_params()

    class Ring:                                   # a plan the table can't hold
        plan = [Segment("dense_local", 2)]
        cfg = model.cfg
        scan_layers = False
    with pytest.raises(NotImplementedError, match="segment kinds"):
        ServeEngine(Ring(), params, ServeConfig())

    class Scanned(Ring):
        plan = model.plan
        scan_layers = True
    with pytest.raises(ValueError, match="scan_layers"):
        ServeEngine(Scanned(), params, ServeConfig())

    class MRope(Ring):
        plan = model.plan
        cfg = reduced(model.cfg, mrope_sections=(2, 3, 3))
    with pytest.raises(NotImplementedError, match="mrope"):
        ServeEngine(MRope(), params, ServeConfig())
    # the SSM and hybrid families build, and the engine refuses them as
    # the reference's does: a padded prompt would run through the state
    for arch in ("mamba2-2.7b", "zamba2-2.7b"):
        ssm_model = LanguageModel(reduced(get_config(arch).model),
                                  device="cpu")
        with pytest.raises(NotImplementedError, match="segment kinds"):
            ServeEngine(ssm_model, ssm_model.init(), ServeConfig())
        ref = JLM(j_reduced(j_get_config(arch).model), head_tp=False)
        with pytest.raises(NotImplementedError, match="segment kinds"):
            JEngine(ref, None, JServeConfig())


def test_launcher_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", "tinyllama-1.1b", "--reduced",
                              "--requests", "5", "--new-tokens", "4",
                              "--swap-every", "3", "--device", "cpu"])
    assert sorted(r.uid for r in done) == list(range(5))
    assert all(len(r.tokens) == 4 for r in done)
    assert "5 requests, 20 tokens" in capsys.readouterr().out
    prompts = launch_serve.request_stream(12, 512)
    assert len(prompts) == 12
    assert all(4 <= len(p) <= 64 and min(p) >= 1 and max(p) < 512
               for p in prompts)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            launch_serve.main(["--arch", "tinyllama-1.1b", "--reduced"])


# -- the MoE family ------------------------------------------------------------

MOE_LAYERS = {"qwen3-moe-30b-a3b": 2, "llama4-maverick-400b-a17b": 3}
# PROMPTS with [7] * 8 replaced by eight distinct tokens: eight equal tokens
# reach the MoE layers as rows equal up to the attention's rounding, so
# which of them an expert's capacity keeps (2 of 8 at the 8-token bucket)
# is decided by ulps the two frameworks round differently: a near-tie, not
# a rule (the exact-tie rule is pinned in test_torch_moe.py)
MOE_PROMPTS = [p if p != [7] * 8 else [7, 1, 8, 2, 6, 1, 9, 3]
               for p in PROMPTS]


@functools.lru_cache(maxsize=None)
def _moe_pair(arch):
    """The reference's and the port's reduced MoE model on the reference's
    weights: Qwen3 (every layer MoE) and Llama4 at 3 layers (a dense-MoE
    pair, whose caches are the {"dense", "moe"} pair, and a dense
    remainder)."""
    shrink = dict(SHRINK, n_layers=MOE_LAYERS[arch])
    jm = JLM(j_reduced(j_get_config(arch).model, **shrink), head_tp=False,
             chunk_k=16, scan_layers=False)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    tm = LanguageModel(reduced(get_config(arch).model, **shrink), chunk_k=16,
                       device="cpu")
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                               jp),
                                       device="cpu")


@pytest.mark.parametrize("arch", list(MOE_LAYERS))
def test_moe_engine_tokens_equal_the_reference_engine(arch):
    """Padded prompts route by their padded rows in both engines (capacity
    is per padded row), and decode is drop-free: the greedy tokens and the
    dispatch counts are the reference engine's."""
    jm, jp, tm, tp = _moe_pair(arch)
    jeng = JEngine(jm, jp, JServeConfig(**_cfg()))
    eng = ServeEngine(tm, tp, ServeConfig(**_cfg()))
    for p in MOE_PROMPTS:
        jeng.submit(p)
        eng.submit(p)
    want = {r.uid: r.tokens for r in jeng.run_until_drained()}
    got = {r.uid: r.tokens for r in eng.run_until_drained()}
    assert got == want
    assert eng.stats["decode_dispatches"] == jeng.stats["decode_dispatches"]
    assert eng.stats["prefill_dispatches"] == \
        jeng.stats["prefill_dispatches"]
    if arch.startswith("llama4"):
        caches = eng._dstate["caches"]
        assert sorted(caches["seg0"]) == ["dense", "moe"]
        assert caches["seg1"].length.shape == (4,)


def test_donated_weights_exist_once():
    """The store and the engine serve the caller's very tensors (as the
    reference's ``serve_fns(model, donate=True)``; the launcher's
    ``build`` relies on it); a swap still stages a copy."""
    params = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    store = ParamStore(params)
    assert store.params["a"].data_ptr() == params["a"].data_ptr()
    assert store.params["b"]["c"].data_ptr() == params["b"]["c"].data_ptr()
    store.publish(params)
    assert store.params["a"].data_ptr() != params["a"].data_ptr()
    model, params, eng = launch_serve.build("qwen3-moe-30b-a3b",
                                            use_reduced=True, device="cpu",
                                            new_tokens=2)
    for (path, a), (_, b) in zip(leaves_with_paths(params),
                                 leaves_with_paths(eng.params)):
        assert a.data_ptr() == b.data_ptr(), path
    eng.submit([1, 2, 3])
    (res,) = eng.run_until_drained()
    assert len(res.tokens) == 2


def test_moe_launcher_on_the_cpu(capsys):
    done = launch_serve.main(["--arch", "qwen3-moe-30b-a3b", "--reduced",
                              "--requests", "3", "--new-tokens", "2",
                              "--device", "cpu"])
    assert sorted(r.uid for r in done) == [0, 1, 2]
    assert "3 requests, 6 tokens" in capsys.readouterr().out
    launch_serve.main(["--arch", "llama4-maverick-400b-a17b", "--reduced",
                       "--layers", "3", "--requests", "2", "--new-tokens",
                       "2", "--swap-every", "1", "--device", "cpu"])
    assert "2 requests, 4 tokens" in capsys.readouterr().out
