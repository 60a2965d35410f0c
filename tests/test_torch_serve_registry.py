"""The serve engine's program registry (``repro_torch.serve.engine``) and
the serve audit (``repro_torch.serve.audit``) against the reference's
engine, on the CPU.

Under ``attach_serve``'s config and waves both engines must report the
same registry: the program names, ``n_programs``, ``max_programs``,
``compiles``, ``steady_compiles`` and ``dropped``; under the
``force-recompile`` mutation both registries must grow past the ceiling
by the same count. A hot swap builds nothing, and a steady wave of new
in-bucket lengths builds nothing (the reference's
``tests/test_serve_engine.py`` pins the same on its engine). The
reference's audits run once per module (``ref_serve``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.audit.mutations import get as ref_mutation
from repro.audit.targets import adhoc_context as ref_adhoc
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.models.transformer import LanguageModel as RefLM
from repro.serve import ServeConfig as RefServeConfig
from repro.serve.audit import attach_serve as ref_attach
from repro_torch.audit.mutations import get as get_mutation
from repro_torch.audit.passes import serve_compile
from repro_torch.audit.targets import REDUCED_OVERRIDES, adhoc_context
from repro_torch.configs import get_config, reduced
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import tree_map
from repro_torch.models.transformer import LanguageModel
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve.audit import attach_serve, serve_audit

MODES = (None, "force-recompile")
KEYS = ("programs", "n_programs", "max_programs", "compiles",
        "steady_compiles", "dropped", "n_prompt_buckets", "n_batch_buckets")


def _serve_cfg(mode):
    return None if mode is None else get_mutation(mode).serve_cfg


@pytest.fixture(scope="module")
def ref_serve():
    """The reference engine's registry counts under its attach_serve, clean
    and under force-recompile."""
    acfg = ref_get_config("tinyllama-1.1b")
    acfg = dataclasses.replace(
        acfg, model=ref_reduced(acfg.model, **REDUCED_OVERRIDES))
    out = {}
    for mode in MODES:
        ctx = ref_adhoc("tinyllama-1.1b-reduced", acfg, {})
        ref_attach(ctx, mutate=(None if mode is None
                                else ref_mutation(mode).serve_cfg))
        out[mode] = ctx.serve
    return out


def _port_ctx(mode):
    acfg = get_config("tinyllama-1.1b")
    acfg = dataclasses.replace(
        acfg, model=reduced(acfg.model, **REDUCED_OVERRIDES))
    ctx = adhoc_context("tinyllama-1.1b-reduced", acfg, {})
    attach_serve(ctx, mutate=_serve_cfg(mode))
    return ctx


def test_serve_config_fields_match_reference():
    """The port's ServeConfig carries the reference's fields and defaults,
    force_recompile (the audit's mutation seam) included."""
    assert [(f.name, f.default) for f in dataclasses.fields(ServeConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(RefServeConfig)]


@pytest.mark.parametrize("mode", MODES)
def test_registry_counts_match_reference(ref_serve, mode):
    port = _port_ctx(mode).serve
    assert {k: port[k] for k in KEYS} == {k: ref_serve[mode][k]
                                          for k in KEYS}


def test_force_recompile_grows_both_registries_alike(ref_serve):
    clean, forced = _port_ctx(None).serve, _port_ctx("force-recompile").serve
    grew = forced["n_programs"] - clean["n_programs"]
    ref_grew = (ref_serve["force-recompile"]["n_programs"]
                - ref_serve[None]["n_programs"])
    assert grew == ref_grew > 0
    assert forced["steady_compiles"] == \
        ref_serve["force-recompile"]["steady_compiles"] > 0


def test_serve_compile_pass_clean_and_bites():
    ctx = _port_ctx(None)
    vs, info = serve_compile(ctx)
    assert vs == [], vs
    assert info["steady_compiles"] == 0 and info["dropped"] == 0
    assert info["n_programs"] == info["max_programs"]
    assert info["table_kept"] == info["table_leaves"] == 3
    # the decode over the slot table: k, v and the per-slot lengths keep
    # their storage, no cache-shaped tensor is made
    assert info["decode_cache_copies"] == 0
    assert info["decode_alias_count"] == \
        ctx.targets["serve_decode"].n_dmd_leaves == 3
    vs, info = serve_compile(_port_ctx("force-recompile"))
    details = " ".join(v.detail for v in vs)
    assert info["steady_compiles"] > 0
    assert "AFTER warmup" in details and "bucket ceiling" in details


def _reduced_model_and_params():
    """The reduced TinyLlama of the serve tests, the reference's init
    carried over."""
    racfg = ref_get_config("tinyllama-1.1b")
    rmc = ref_reduced(racfg.model, **REDUCED_OVERRIDES)
    rparams = RefLM(rmc, head_tp=False, chunk_k=16, scan_layers=False).init(
        jax.random.PRNGKey(0))
    mc = reduced(get_config("tinyllama-1.1b").model, **REDUCED_OVERRIDES)
    model = LanguageModel(mc, chunk_k=16, device="cpu")
    return model, params_from_jax(
        jax.tree_util.tree_map(np.asarray, rparams), device="cpu")


def test_steady_state_never_recompiles():
    """Warm-up touches every bucket; the steady wave's new in-bucket
    lengths build nothing, and the slot table keeps its storage."""
    model, params = _reduced_model_and_params()
    info, _, eng = serve_audit(model, params)
    assert eng.stats["steady_compiles"] == 0
    assert eng.n_programs == eng.max_programs == 8
    assert eng.stats["compiles"] == 7
    assert info["table_kept"] == info["table_leaves"] == 3


def test_swap_compiles_nothing():
    """A swapped-in version serves the cold-started engine's tokens and
    logits bit for bit, and the swap builds no program."""
    model, params = _reduced_model_and_params()
    bumped = tree_map(lambda t: t * 1.5, params)
    cfg = ServeConfig(n_slots=4, prompt_buckets=(4, 8), batch_buckets=(1, 2),
                      max_new_tokens=5)
    hot = ServeEngine(model, tree_map(lambda t: t.clone(), params), cfg)
    hot.submit([1, 2, 3])
    hot.run_until_drained()
    before = hot.stats["compiles"]
    assert hot.swap_weights(bumped, version=7) == 7
    assert hot.stats["compiles"] == before
    cold = ServeEngine(model, bumped, cfg)
    for p in ([1, 2, 3], [5, 6, 7, 8, 9], [2, 4]):
        hot.submit(p)
        cold.submit(p)
    rh = {r.uid: r for r in hot.run_until_drained()}
    rc = {r.uid: r for r in cold.run_until_drained()}
    for uh, uc in zip(sorted(rh), sorted(rc)):
        assert rh[uh].tokens == rc[uc].tokens
        np.testing.assert_array_equal(rh[uh].last_logits,
                                      rc[uc].last_logits)
        assert (rh[uh].version_start, rh[uh].version_end) == (7, 7)
    assert hot.stats["compiles"] == cold.stats["compiles"]
    assert hot.stats["dropped"] == 0
    assert torch.equal(hot.params["emb"], bumped["emb"])
