"""Tensor-parallel compute over "model" (``distributed/tensor_parallel.py``
and the models' mesh paths) on four spawned gloo ranks on the CPU,
against the one-process port and the reference on the same numpy inputs.

One spawn for the file (``ranks``, a module fixture): every rank runs
``torch_tp_worker.tp_checks`` and the cases below read its results. The
process group times out after 60 s and the spawn after 120 s. The
reference side (``repro.models.transformer.LanguageModel(head_tp=...,
pad_heads_to=...)`` on one device, with the case's ``head_tp``) runs
here, in the test process.

Each case of ``torch_tp_worker.CASES`` is a small fp32 config of one
layout: GQA with its kv heads split, MQA with its one kv head gathered,
an MHA padded 6 -> 8 whose heads move between the ranks, GQA padded and
aligned, 4 experts over 2 ranks (and a dense-MoE pair with a shared
expert), an SSM of 4 heads over 2 ranks (and Zamba's shared block),
Gemma's window layers and soft-capped logits, Whisper's cross-attention;
tied and untied heads, a padded vocabulary; then kv-SP (k and v split by
sequence over "model", q whole on every rank): GQA causal on (2, 2) and
on (1, 4) over 18 tokens (uneven blocks), Gemma's window layers, Whisper
as its config lays it out (kv-SP in every attention, the encoder's and
the cross-attention's over 15 frames), and head-TP with 6 heads over 4
(the core's heads padded for the call). Tolerance: the loss relative
1e-5 and each leaf's gradient 1e-5 of the leaf's largest entry, on the
(2, 2) mesh against one process, and against the reference beyond one
process's own distance from it (the port's SSD already sits up to 8e-6
of a leaf's largest gradient from the reference's on one device, in
fp32: the mesh may add 1e-5 to that); a Trainer with DMD on (2, 2)
against one process by the Trainer tests' rule (1e-5 up to the first
jump, 2e-3 after).
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_tp_worker as W
from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced as j_reduced
from repro.models.transformer import LanguageModel as JLM
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths
from repro_torch.launch.mesh import run_ranks

TOL = 1e-5
TRAIN_TOL = (1e-5, 2e-3)
# the collectives that move heads or kv columns between the ranks, by case
# (the others' layouts need none); kv-SP all-gathers q to every head and
# k, v to every kv head, and keeps its own columns of the output locally
MOVES = {"mha-moved": {"attn.q", "attn.k", "attn.v", "attn.out"},
         "mqa": {"attn.k", "attn.v"},
         "gqa-kvsp": {"attn.q", "attn.k", "attn.v"},
         "gqa-kvsp-1x4": {"attn.q", "attn.k", "attn.v"},
         "gemma-kvsp": {"attn.q", "attn.k", "attn.v"},
         "whisper-kvsp": {"attn.q", "attn.k", "attn.v"},
         "heads-6-over-4": {"attn.q", "attn.k", "attn.v", "attn.out"}}
# the kv-SP cases: their merge's two all-reduces and dO's sum over "model"
KV_SP = ("gqa-kvsp", "gqa-kvsp-1x4", "gemma-kvsp", "whisper-kvsp")
MERGE = {"attn.merge.max", "attn.merge.sum", "attn.merge.dout"}


def _j_model_cfg(name: str):
    """The reference's config of a case (its sub-configs rebuilt from the
    port's fields)."""
    arch, over, _ = W.CASES[name]
    jm = j_get_config(arch).model
    over = {k: (dataclasses.replace(getattr(jm, k), **dataclasses.asdict(v))
                if dataclasses.is_dataclass(v) else v)
            for k, v in over.items()}
    return j_reduced(jm, **over)


def _j_model(name: str):
    return JLM(_j_model_cfg(name), head_tp=W.head_tp(name), chunk_k=16,
               pad_heads_to=W.CASES[name][2])


@pytest.fixture(scope="module")
def inputs():
    """The reference's initial params of every case (numpy)."""
    return {name: jax.tree_util.tree_map(
        np.asarray, _j_model(name).init(jax.random.PRNGKey(0)))
        for name in W.CASES}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    tmp = str(tmp_path_factory.mktemp("tp"))
    return run_ranks(W.tp_checks, 4, inputs, tmp, join_timeout=120,
                     tmp_dir=tmp)


def _ref(name: str, params) -> tuple:
    """The reference's loss and gradient by path on one device."""
    model = _j_model(name)
    batch = {k: jnp.asarray(v) for k, v in W.batches(name)[0].items()}
    p = jax.tree_util.tree_map(jnp.asarray, params)
    loss, g = jax.value_and_grad(lambda q: model.loss(q, batch)[0])(p)
    grads = params_from_jax(jax.tree_util.tree_map(np.asarray, g),
                            device="cpu")
    return float(loss), {k: v.numpy() for k, v in leaves_with_paths(grads)}


@pytest.mark.parametrize("name", list(W.CASES))
def test_tp_matches_one_process(ranks, name):
    """On the (2, 2) mesh every rank's loss and gradient blocks equal one
    process's on the same params and batch; no param block is all-gathered
    over "model"; heads move between the ranks exactly where the layout
    needs it."""
    for r in ranks:
        res = r["cases"][name]
        assert res["loss"] == pytest.approx(res["loss_one"], rel=TOL)
        assert res["loss"] == ranks[0]["cases"][name]["loss"]
        assert max(res["grad_err"].values()) <= TOL, res["grad_err"]
        assert res["model_gathers"] == 0
        moved = {"attn.q", "attn.k", "attn.v", "attn.out"} & set(
            res["sites"])
        assert moved == MOVES.get(name, set()), res["sites"]
        assert (MERGE <= set(res["sites"])) == (name in KV_SP), res["sites"]


@pytest.mark.parametrize("name", list(W.CASES))
def test_tp_matches_reference(ranks, inputs, name):
    """The mesh's loss and its gradient (every rank's blocks gathered)
    against the reference's ``LanguageModel(head_tp=..., pad_heads_to=...)``
    on one device, built with the case's ``head_tp`` (its values do not
    depend on the layout), from the same params and batch:
    each leaf within 1e-5 of its largest entry beyond one process's own
    distance from the reference."""
    loss, want = _ref(name, inputs[name])
    res = ranks[0]["cases"][name]
    assert res["loss"] == pytest.approx(loss, rel=TOL)
    got, one = res["grads"], res["grads_one"]
    assert set(got) == set(want)

    def err(a, w):
        return float(np.abs(a - w).max() / max(np.abs(w).max(), 1e-30))
    over = {p: err(got[p], w) - err(one[p], w) for p, w in want.items()}
    assert max(over.values()) <= TOL, over


@pytest.mark.parametrize("fault", list(W.FAULTS))
def test_planted_faults_fail(ranks, fault):
    """The checks can fail: a row-parallel all-reduce dropped (the MLP's
    w_out), a replicated param's gradient sum over "model" dropped (the
    SSM's norm_scale), kv-SP's merge without its weights (each rank keeps
    the attention over its own keys) and kv-SP's dq without its sum over
    "model" each put a gradient off one process's by far more than the
    tolerance; the two that change the forward, its loss too."""
    for r in ranks:
        res = r["faults"][fault]
        assert max(res["grad_err"].values()) > 100 * TOL, res["grad_err"]
    if fault in ("drop-row-sum", "kv-sp-unweighted-merge"):
        res = ranks[0]["faults"][fault]
        assert abs(res["loss"] - res["loss_one"]) > TOL * res["loss_one"]


def test_trainer_with_dmd_on_the_mesh(ranks):
    """The padded, moving MHA case trained with DMD on (2, 2) (AdamW, the
    clip's norm over the blocks, a jump at 9) against one process: the
    same jump, the losses within the Trainer tests' rule, and the same
    losses on every rank."""
    got, want = ranks[0]["train"], ranks[0]["train_one"]
    assert got["jumps"] == want["jumps"] and got["jumps"]
    k = want["jumps"][0] + 1
    g, w = np.asarray(got["losses"]), np.asarray(want["losses"])
    np.testing.assert_allclose(g[:k], w[:k], rtol=TRAIN_TOL[0])
    np.testing.assert_allclose(g, w, rtol=TRAIN_TOL[1])
    for r in ranks[1:]:
        assert r["train"]["losses"] == got["losses"]


# -- the launcher ------------------------------------------------------------

def test_launcher_pads_heads_only_under_a_model_axis():
    """``make_model`` passes the config's ``pad_attn_heads_to`` (MiniCPM:
    16) under a mesh whose "model" axis is larger than one, as the
    reference's launcher does, and none without one (or at "model" 1)."""
    from repro_torch.launch import train as launch_train

    acfg = get_config("minicpm-2b")
    assert acfg.parallel.pad_attn_heads_to == 16

    def mesh(model):
        return SimpleNamespace(axis_size=lambda a: {"model": model}[a])
    for m, want in ((None, 0), (mesh(1), 0), (mesh(2), 16)):
        model = launch_train.make_model(acfg, reduced=True, device="cpu",
                                        mesh=m)
        assert model.pad_heads_to == want


def test_launcher_trains_padded_minicpm_on_a_mesh(capfd):
    """``launch.train --arch minicpm-2b --reduced --mesh 2x2`` trains
    head-parallel with its 4 heads padded to 16 (8 a rank): every step
    runs and the loss is finite."""
    from repro_torch.launch import train as launch_train

    launch_train.main(["--arch", "minicpm-2b", "--reduced", "--device",
                       "cpu", "--mesh", "2x2", "--steps", "12",
                       "--global-batch", "4", "--seq", "16"])
    out = capfd.readouterr().out
    assert "heads padded to 16" in out and "12 steps in" in out, out
    assert "nan" not in out.split("12 steps in")[1], out


def test_check_fits_reckons_the_model_blocks_a_rank_reads():
    """Under a (2, 2) mesh a rank's forward reads its "model" blocks,
    gathered over "data": half of every param the rules split over
    "model", all of the others; ``check_fits`` reckons those, not the
    full params."""
    from repro_torch.launch import train as launch_train

    acfg = launch_train.configure("tinyllama-1.1b", steps=1, reduced=True)
    model = launch_train.make_model(acfg, reduced=True, device="cpu")
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=SimpleNamespace(shape=(2, 2)))
    n = launch_train.param_count(model)
    read = launch_train.local_param_count(model, mesh, model_only=True)
    local = launch_train.local_param_count(model, mesh)
    c = acfg.model
    # the matrices split over "model": emb, lm_head, wq, wk, wv, wo, w_in,
    # w_gate, w_out; the norms' scales are replicated
    split = (2 * c.padded_vocab * c.d_model + c.n_layers * (
        2 * c.d_model * c.q_dim + 2 * c.d_model * c.kv_dim
        + 3 * c.d_model * c.d_ff))
    assert read == n - split // 2 and local < read < n
    full = launch_train.check_fits(acfg, n, 1 << 50, n_local=local)
    tp = launch_train.check_fits(acfg, n, 1 << 50, n_local=local,
                                 n_read=read)
    p = 2 if c.dtype == "bfloat16" else 4
    assert full - tp == (2 * p + 4) * (n - read)


# -- the reference's choice of layout -----------------------------------------

@pytest.mark.parametrize("arch", [a for a in j_list_archs()
                                  if j_get_config(a).model.family != "mlp"])
def test_head_tp_resolves_as_the_reference(arch):
    """For every architecture and every ``head_tp`` argument, the port's
    ``LanguageModel`` holds the layout the reference's resolves to: None is
    head-TP where the q heads are a multiple of the reference's 16 (not
    the live "model" axis), kv-SP otherwise."""
    from repro_torch.models.transformer import LanguageModel

    cfg, jcfg = get_config(arch).model, j_get_config(arch).model
    for head_tp in (None, True, False):
        got = LanguageModel(cfg, head_tp=head_tp, device="cpu").head_tp
        assert got is JLM(jcfg, head_tp=head_tp).head_tp, (arch, head_tp)
    assert LanguageModel(cfg, device="cpu").head_tp == (cfg.n_heads % 16
                                                        == 0)


@pytest.mark.parametrize("reduced", [False, True])
def test_launchers_and_audit_targets_choose_the_references_layout(reduced):
    """``launch.train.make_model`` and ``launch.serve`` pass ``head_tp=not
    reduced``, as the reference's launchers do; the audit targets' model
    resolves as the reference's targets' (kv-SP when reduced, the rule
    otherwise) and runs its remat, "none", for every architecture."""
    from repro.audit import targets as j_targets
    from repro_torch.audit import targets as t_targets
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch import train as launch_train

    for arch in ("tinyllama-1.1b", "whisper-base", "minicpm-2b"):
        acfg = launch_train.configure(arch, steps=1, reduced=reduced)
        model = launch_train.make_model(acfg, reduced=reduced, device="cpu")
        assert model.head_tp is (not reduced), arch
    model, _ = launch_serve.model_and_params(
        "tinyllama-1.1b", use_reduced=reduced, device="cpu", n_layers=1)
    assert model.head_tp is (not reduced)
    for arch in j_list_archs():
        want = j_targets._build_model_and_config(arch, reduced)[0]
        got = t_targets._build_model_and_config(arch, reduced, "cpu")[0]
        if not hasattr(want, "head_tp"):
            continue                                # the paper MLP
        assert got.head_tp is want.head_tp, arch
        assert got.remat == want.remat == "none", arch
        assert got.chunk_k == want.chunk_k and got.pad_heads_to == 0, arch
