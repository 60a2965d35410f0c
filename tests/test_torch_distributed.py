"""The port's mesh on four spawned gloo ranks on the CPU, against the
reference on the same numpy inputs.

One spawn for the whole file (``ranks``, a module fixture): every rank
runs ``torch_mesh_worker.mesh_checks`` (the data passes per block, the
int8 pod sync, Trainers on a (2, 2) mesh, elastic restores and the mesh
audit) and the parametrised cases below read its results. The ranks meet
through a ``FileStore`` under the test's temporary directory; the process
group times out after 60 s and the spawn after 120 s, so a hang fails
these tests instead of the suite. The reference side (its unsharded
``kernels/ref.py`` math, its ``_quantize_psum`` and its single-device
Trainer, built on ``make_train_step``) runs here, in the test process:
the reference's own sharded record path is not usable under this JAX
(``tests/test_sharded_kernels.py``).

Tolerances: the data passes per block against the reference's unsharded
math, fp32 relative 2e-6 of the largest entry (a sum over two or four
blocks in another order), bit for bit on integer-valued (dyadic)
trajectories and for every combine; a Trainer on the mesh against the
one-process Trainer and the reference's, relative 1e-5 in the losses up
to the first jump and 2e-3 after (the Trainer tests' rule: only the order
of fp32 sums differs, and a jump amplifies it).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_worker as W
from benchmarks.paper_benches import _MLPModel
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import DMDConfig as JDMD
from repro.configs.base import DMDControllerConfig as JCtrl
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import TrainConfig as JTrain
from repro.distributed.gradsync import _quantize_psum
from repro.distributed.sharding import shard_map
from repro.kernels import ref as jref
from repro.models.mlp_net import init_mlp as j_init_mlp
from repro.models.transformer import LanguageModel as JLM
from repro.train import Trainer as JTrainer
from repro_torch.configs.base import DMDConfig
from repro_torch.convert import params_from_jax
from repro_torch.distributed import checks
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.mlp_net import MLPModel
from repro_torch.models.transformer import LanguageModel
from repro_torch.train import Trainer

KERNEL_CASES = [(mesh, case, arena, dyadic)
                for mesh in ("2x2", "1x2") for case in ("lm", "sys")
                for arena in (True, False) for dyadic in (True, False)]
FP32_TOL = 2e-6
# the LM's final params on the mesh against one process: each leaf's L2
# distance over the L2 distance it moved (1.0e-4 measured at the largest,
# on this CPU). The MLP is held by its held-out loss instead: its two jumps
# amplify fp32 noise to 13% of /l0/w's move between two one-process runs
# that differ only in their sum order (the arena and per-leaf routes).
LM_PARAM_TOL = 1e-3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def inits():
    """The reference's initial params of the small LM and the MLP."""
    jm = j_reduced(j_get_config("tinyllama-1.1b").model, **W.SMALL)
    lm = _np_tree(JLM(jm, head_tp=False, chunk_k=16).init(
        jax.random.PRNGKey(0)))
    mlp = _np_tree(j_init_mlp(jax.random.PRNGKey(0), W.MLP_SIZES))
    return {"lm_init": lm, "mlp_init": mlp}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inits):
    tmp = str(tmp_path_factory.mktemp("mesh"))
    return run_ranks(W.mesh_checks, 4, inits, tmp, join_timeout=120,
                     tmp_dir=tmp)


# -- the data passes per block ----------------------------------------------

def _ref_grams(case: str, dyadic: bool) -> dict:
    """Each leaf's full (stack..., m, m) Gram and combine by the
    reference's unsharded math (``kernels/ref.py``) on the full ring."""
    m = 4
    traj = W.trajectory(case, m, dyadic, seed=3 + int(dyadic))
    coeffs = W.coefficients(case, m, seed=11)
    sd = W.kernel_stack_dims(case)
    anchor = DMDConfig().anchor == "first"
    grams, combos = {}, {}
    for path in traj[0]:
        ring = np.stack([t[path] for t in traj])            # (m, *shape)
        stack = ring.shape[1:1 + sd[path]]
        flat = ring.reshape((m, int(np.prod(stack, dtype=np.int64)), -1))
        c = coeffs[path].reshape(flat.shape[1], m)
        g = [np.asarray(jref.gram_ref(jnp.asarray(flat[:, s]),
                                      anchor_first=anchor))
             for s in range(flat.shape[1])]
        w = [np.asarray(jref.combine_ref(jnp.asarray(flat[:, s]),
                                         jnp.asarray(c[s])))
             for s in range(flat.shape[1])]
        grams[path] = np.stack(g).reshape(stack + (m, m))
        combos[path] = np.stack(w).reshape(ring.shape[1:])
    return grams, combos


def _close(got, want, exact: bool, what: str):
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(np.asarray(got) - want).max()) / scale
        assert err <= FP32_TOL, (what, err)


@pytest.mark.parametrize("key", KERNEL_CASES, ids=lambda k: "-".join(
    [k[0], k[1], "arena" if k[2] else "perleaf",
     "dyadic" if k[3] else "fp32"]))
def test_sharded_data_passes_match_reference(ranks, key):
    """K1 / K4 streamed and K3 / K6 recomputed per block, then one
    all-reduce, against the reference's unsharded ``gram_ref`` on the full
    ring; K2 / K5 per block equal the one-rank kernel's block bit for bit
    and, gathered, the reference's ``combine_ref``. Integer-valued
    trajectories are bit-exact, and so is the mesh against one rank."""
    mesh, case, arena, dyadic = key
    want_g, want_w = _ref_grams(case, dyadic)
    members = [r for r in ranks if key in r["kernels"]]
    assert len(members) == (4 if mesh == "2x2" else 2)
    res = members[0]["kernels"][key]
    assert set(res["streamed"]) == set(want_g)
    for path, g in want_g.items():
        _close(res["streamed"][path], g, dyadic, f"K1/K4 {path}")
        _close(res["recomputed"][path], g, dyadic, f"K6 {path}")
        if arena:
            _close(res["k3"][path], g, dyadic, f"K3 {path}")
        _close(res["k2_full"][path], want_w[path], dyadic, f"K5 {path}")
        assert res["k2_slice_equal"][path], path
        if dyadic:
            assert res["streamed_equal_one"][path], path
        if arena:
            assert res["k2_bucket_equal"][path], path
    for other in members[1:]:
        for path in want_g:
            np.testing.assert_array_equal(other["kernels"][key]["streamed"]
                                          [path], res["streamed"][path])


def test_record_makes_the_analytic_allreduces_only(ranks):
    """Each record sums every lane-sharded bucket's (n_sys, m) fp32 rows
    with ONE all-reduce (per leaf on the per-leaf route) and makes no
    other collective; a system-sharded bucket reduces only its own
    systems' rows."""
    res = ranks[0]["kernels"]
    lm = res[("2x2", "lm", True, False)]
    assert lm["buckets"]["g0-float32-data+model"] == (
        ("data", "model"), (), 16, 16)
    sys_b = res[("2x2", "sys", True, False)]["buckets"]
    assert sys_b["g0-float32-model-sysdata-.stacked"] == (
        ("model",), ("data",), 2, 4)
    for key, r in res.items():
        for rec in r["record_collectives"]:
            assert all(kind == "all_reduce" for kind, _ in rec), key
        if key[2]:
            want = sum(n_sys * 4 * 4 for lane, _, n_sys, _ in
                       r["buckets"].values() if lane)
            assert [sum(b for _, b in rec)
                    for rec in r["record_collectives"]] == [want] * 4, key


# -- int8 gradient sync -----------------------------------------------------

def _ref_quantize(g: np.ndarray) -> np.ndarray:
    """The reference's ``_quantize_psum`` on a one-device mesh with a
    "pod" axis (one pod: the rescaled int8 payload itself)."""
    mesh = jax.make_mesh((1,), ("pod",))
    P = jax.sharding.PartitionSpec
    fn = shard_map(_quantize_psum, mesh=mesh, in_specs=(P(),),
                   out_specs=P(), check_rep=False)
    return np.asarray(jax.jit(fn)(jnp.asarray(g)))


def test_int8_psum_grads_matches_reference(ranks):
    """On a (2, 1, 2) pod mesh. Replicated across pods: the pod mean of
    the int8 payload is the reference's one-pod result to 1e-6 relative
    (XLA divides by the constant 127 as a multiply by its reciprocal, an
    ulp from torch's division), within scale * 1.01 of the input. Pods that differ: the reference's formula,
    sum(q_p) * scale_local / npods. The wire is one int32 all-reduce over
    "pod" (no backend reduces the reference's int16)."""
    g = ranks[0]["gradsync"]["input"]
    scale = float(np.abs(g).max()) / 127.0
    for r in ranks:
        gs = r["gradsync"]
        np.testing.assert_allclose(gs["same"], _ref_quantize(g), rtol=1e-6,
                                   atol=0)
        assert float(np.abs(gs["same"] - g).max()) <= scale * 1.01 + 1e-6
        assert gs["wire"] == [("all_reduce", "int32", ("pod",))]
    # ranks 2p and 2p + 1 are pod p's
    pods = [ranks[2 * p]["gradsync"]["pod_input"] for p in (0, 1)]
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["gradsync"]["pod_input"],
                                      pods[rank // 2])
    scales = [np.float32(np.abs(x).max()) / np.float32(127.0) for x in pods]
    q = sum(np.clip(np.round(x / s), -127, 127).astype(np.int32)
            for x, s in zip(pods, scales))
    for rank, r in enumerate(ranks):
        pod = rank // 2
        want = q.astype(np.float32) * scales[pod] / np.float32(2.0)
        np.testing.assert_allclose(r["gradsync"]["diff"], want, rtol=1e-6)


def test_int8_grad_compression_in_the_train_step(ranks):
    """``parallel.grad_compression = "int8"`` on a pod mesh: each step
    sends every gradient leaf across the pods as int8 (one int32
    all-reduce over "pod" a leaf; the resident MLP's gradient is its one
    flat bucket, as the reference's is: one a step, 12 steps), after the
    batch axes' reduction, and trains as the uncompressed run does within
    the quantisation's noise."""
    for r in ranks:
        res = r["int8_trainer"]
        assert res["none"]["int32_pod"] == 0
        assert res["int8"]["int32_pod"] == 12
        assert res["int8"]["jumps"] == res["none"]["jumps"]
        np.testing.assert_allclose(res["int8"]["losses"],
                                   res["none"]["losses"], rtol=2e-2)
        assert res["int8"]["losses"] == ranks[0]["int8_trainer"]["int8"][
            "losses"]


# -- Trainers on the (2, 2) mesh --------------------------------------------

def _ref_cfg(name: str):
    if name.startswith("lm"):
        acfg = j_get_config("tinyllama-1.1b")
        return dataclasses.replace(
            acfg, model=j_reduced(acfg.model, **W.SMALL),
            dmd=JDMD(**W.LM_DMD, controller=JCtrl(
                enabled=name.endswith("ctrl"))),
            optimizer=JOpt(**W.LM_OPT),
            parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                         remat="none"),
            train=JTrain(global_batch=W.LM_B, seq_len=W.LM_S))
    return JArch(
        model=JModel(name="mlp", family="mlp"),
        dmd=JDMD(**W.MLP_DMD, arena=name != "mlp-perleaf",
                 controller=JCtrl(enabled=name.endswith("ctrl"))),
        optimizer=JOpt(name="adam", lr=1e-3), parallel=JPar(grad_accum=1),
        train=JTrain(global_batch=W.MLP_N, seq_len=1), shapes=())


def _port_cfg(name: str):
    if name.startswith("lm"):
        return W.lm_cfg(ctrl=name.endswith("ctrl"))
    return W.mlp_cfg(ctrl=name.endswith("ctrl"), arena=name != "mlp-perleaf")


def _runs(name: str, inits: dict, ref: bool) -> dict:
    """One Trainer run without a mesh: the port's, or the reference's
    (single device, its ``make_train_step``)."""
    lm = name.startswith("lm")
    init = inits["lm_init" if lm else "mlp_init"]
    train, val = W.mlp_data()
    if lm:
        batches, steps = W.lm_batches(W.LM_STEPS), W.LM_STEPS
    else:
        batches, steps = [train] * W.MLP_STEPS, W.MLP_STEPS
    gated = name.endswith("ctrl")
    losses, jumps, outcomes = [], [], []

    def on_m(t, m):
        losses.append(float(m["loss"]))
        if "mean_rank" in m:
            jumps.append(t)
        if "ctrl_outcome" in m:
            outcomes.append(int(m["ctrl_outcome"]))
    if ref:
        acfg = _ref_cfg(name)
        model = (JLM(acfg.model, head_tp=False, chunk_k=16) if lm
                 else _MLPModel(W.MLP_SIZES))
        tr = JTrainer(model, acfg, val_batch=val if gated and not lm
                      else None)
        st = tr.init_state()
        params = jax.tree_util.tree_map(jnp.asarray, init)
        st = st._replace(params=params, opt_state=tr.opt.init(params))
        tr.fit(iter([{k: jnp.asarray(v) for k, v in b.items()}
                     for b in batches]), steps, state=st, on_metrics=on_m)
        params = None
    else:
        acfg = _port_cfg(name)
        model = (LanguageModel(acfg.model, chunk_k=16, device="cpu") if lm
                 else MLPModel(W.MLP_SIZES))
        tr = Trainer(model, acfg, device="cpu",
                     val_batch=({k: torch.from_numpy(v)
                                 for k, v in val.items()}
                                if gated and not lm else None))
        st = tr.init_state(params=params_from_jax(init, device="cpu"))
        st = tr.fit(iter([{k: torch.from_numpy(v) for k, v in b.items()}
                          for b in batches]), steps, state=st,
                    on_metrics=on_m)
        from repro_torch.core.paths import leaves_with_paths
        params = {p: x.detach().float().numpy()
                  for p, x in leaves_with_paths(st.params)}
    return {"losses": np.asarray(losses), "jumps": jumps,
            "outcomes": outcomes, "params": params}


def _held_out(name: str, params: dict) -> float:
    """The loss of full params on data no run trained on."""
    tree = checks.nest({p: torch.from_numpy(np.asarray(x))
                    for p, x in params.items()})
    with torch.no_grad():
        if name.startswith("lm"):
            model = LanguageModel(_port_cfg(name).model, chunk_k=16,
                                  device="cpu")
            batch = W.lm_batches(1, seed=99)[0]
            return float(model.loss(tree, {k: torch.from_numpy(v)
                                           for k, v in batch.items()})[0])
        _, val = W.mlp_data()
        return float(MLPModel(W.MLP_SIZES).loss(
            tree, {k: torch.from_numpy(v) for k, v in val.items()})[0])


def _param_errs(got: dict, want: dict, init: dict) -> dict:
    """Per leaf: ||got - want|| / ||want - init|| (how far apart the two
    runs ended over how far the leaf moved; a run that never updated its
    params scores 1)."""
    return {p: float(np.linalg.norm(got[p] - w)
                     / max(np.linalg.norm(w - init[p]), 1e-30))
            for p, w in want.items()}


def _init_of(name: str, inits: dict) -> dict:
    from repro_torch.core.paths import leaves_with_paths
    init = inits["lm_init" if name.startswith("lm") else "mlp_init"]
    return {p: x.numpy() for p, x in leaves_with_paths(
        params_from_jax(init, device="cpu"))}


def _check_run(got: dict, want: dict, what: str):
    assert got["jumps"] == want["jumps"], what
    assert got["outcomes"] == want["outcomes"], what
    k = want["jumps"][0] + 1
    gl = np.asarray(got["losses"])
    np.testing.assert_allclose(gl[:k], want["losses"][:k], rtol=1e-5,
                               err_msg=what)
    np.testing.assert_allclose(gl, want["losses"], rtol=2e-3, err_msg=what)


PARITY = ("lm", "lm-ctrl", "mlp", "mlp-perleaf", "mlp-ctrl")


@pytest.mark.parametrize("name", PARITY)
def test_mesh_trainer_matches_one_process(ranks, inits, name):
    """A Trainer on the (2, 2) mesh (the LM's matrices sharded over data
    and model, the batch over data) against the port's one-process
    Trainer: the same jumps and gate outcomes, the losses within the
    Trainer tests' rule, the LM's final params within LM_PARAM_TOL of
    their move, and the final params' held-out loss within 2e-3 (the
    MLP's two jumps amplify fp32 noise most in its smallest leaves, which
    the loss weighs least). Every rank reports the same
    losses, and the coefficients are the same bits on every rank, before
    the broadcast from rank 0 as after it."""
    got = ranks[0]["parity"][name]
    want = _runs(name, inits, ref=False)
    _check_run(got, want, name)
    assert set(got["params"]) == set(want["params"])
    if name.startswith("lm"):
        errs = _param_errs(got["params"], want["params"],
                           _init_of(name, inits))
        assert max(errs.values()) <= LM_PARAM_TOL, errs
    assert _held_out(name, got["params"]) == pytest.approx(
        _held_out(name, want["params"]), rel=2e-3)
    assert got["c_after"] and len(got["c_after"]) == len(got["jumps"]) * (
        1 if name != "mlp-perleaf" else 6)
    for r in ranks[1:]:
        other = r["parity"][name]
        assert other["losses"] == got["losses"], name
        assert other["c_after"] == got["c_after"], name
        assert other["c_before"] == got["c_before"], name


@pytest.mark.parametrize("name", ("lm", "mlp", "mlp-ctrl"))
def test_mesh_trainer_matches_reference(ranks, inits, name):
    """The same runs against the reference's single-device Trainer (its
    ``make_train_step`` and jump) from the same init on the same numpy
    batches."""
    got = ranks[0]["parity"][name]
    want = _runs(name, inits, ref=True)
    _check_run(got, want, name)


def test_planted_fault_fails_the_mesh_parity(ranks, inits):
    """The parity checks can fail: the small LM on the (2, 2) mesh with
    the gradient's sum over the batch axes dropped (each data rank trains
    on its own rows) is off the one-process run by more than the losses'
    tolerance before the first jump and the params' tolerance."""
    got = ranks[0]["fault"]
    want = _runs("lm", inits, ref=False)
    k = want["jumps"][0] + 1
    loss = float(np.max(np.abs(np.asarray(got["losses"][:k])
                               - want["losses"][:k])
                        / np.abs(want["losses"][:k])))
    errs = _param_errs(got["params"], want["params"], _init_of("lm", inits))
    assert loss > 1e-5 and max(errs.values()) > LM_PARAM_TOL, (loss, errs)


# -- elastic restores -------------------------------------------------------

@pytest.mark.parametrize("target", W.TARGETS)
@pytest.mark.parametrize("case", W.ELASTIC)
def test_elastic_restore_continues_the_run(ranks, case, target):
    """A run on (2, 2) preempted (a SIGTERM on rank 0 alone, which every
    rank follows after the same step) and restored onto (4, 1), (1, 4)
    and one rank continues as the uninterrupted run: the same step, the
    same later jumps, the losses within the Trainer tests' rule, and every
    restored running Gram equal to the recompute of its restored ring over
    the current window's rows. Cases: the gated controller saved after its
    jump step and mid-window, the small LM's resident arena with
    lane-sharded buckets, and the Gram variants keep / zero (saved without
    Grams) / hetero (two groups of different windows)."""
    r0 = ranks[0]["elastic"][case]
    assert r0["saved"] == W.SAVE_AT[case]
    res = r0[target]
    assert res["start"] == r0["saved"]
    want = np.asarray(r0["uninterrupted"])[res["start"]:]
    got = np.asarray(res["losses"])
    assert res["jumps"] == [j for j in r0["jumps"] if j >= res["start"]]
    later = [j - res["start"] for j in res["jumps"]]
    k = later[0] + 1 if later else len(got)
    np.testing.assert_allclose(got[:k], want[:k], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-3)
    if case != "ctrl-jump":
        assert res["gram_err"], "no window rows to check"
    # the repo's rule for a carried Gram against K3's recompute: 1e-4 of
    # its largest entry (fp32 sums in another order, anchored)
    assert all(e <= 1e-4 for e in res["gram_err"].values()), res["gram_err"]
    if target != "one":
        for r in ranks[1:]:
            assert r["elastic"][case][target]["losses"] == res["losses"]


# -- the audit under a mesh -------------------------------------------------

def test_mesh_audit_green_and_force_allgather_fails_the_budget(ranks):
    """``--mesh 2x2`` on the small LM, which attends in kv-SP as the
    reference's reduced audit target does (its merge's collectives
    made): every pass clean on every rank, the record's collectives
    exactly the analytic all-reduce bytes; with ``force-allgather``
    exactly collective-budget fails."""
    for r in ranks:
        a = r["audit"]
        assert a["clean"]["merges"] > 0
        assert a["clean"]["failed"] == []
        assert a["clean"]["record"] == {"all_reduce": [1, a["clean"]
                                                       ["analytic"]]}
        assert a["clean"]["analytic"] > 0
        assert a["force-allgather"]["failed"] == ["collective-budget"]
        assert "all_gather" in a["force-allgather"]["record"]


def test_mesh_audit_force_gather_model_fails_the_budget(ranks):
    """Under ``--mesh 2x2`` the clean build's train_step gathers no param
    block over "model" (its compute is tensor-parallel); with
    ``force-gather-model`` (the gather-everything compute before it) it
    does, and exactly collective-budget fails."""
    for r in ranks:
        a = r["audit"]
        assert a["clean"]["model_gathers"] == 0
        assert a["force-gather-model"]["model_gathers"] > 0
        assert a["force-gather-model"]["failed"] == ["collective-budget"]


# -- the entry points -------------------------------------------------------

def test_launcher_trains_on_a_mesh(tmp_path):
    """``python -m repro_torch.launch.train --mesh 2x2`` without torchrun
    spawns the mesh's four ranks itself and trains, checkpointing; the
    checkpoint it writes is the one-card format (a one-process launcher
    resumes from it)."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as launch_train

    ckpt = str(tmp_path / "ckpt")
    launch_train.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                       "cpu", "--mesh", "2x2", "--steps", "50", "--ckpt",
                       ckpt, "--global-batch", "4", "--seq", "16"])
    assert latest_step(ckpt) == 50
    launch_train.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                       "cpu", "--steps", "52", "--ckpt", ckpt,
                       "--global-batch", "4", "--seq", "16"])
    with pytest.raises(ValueError, match="needs 4 ranks; torchrun started 2"):
        import os
        env = dict(RANK="0", WORLD_SIZE="2")
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            launch_train.main(["--arch", "tinyllama-1.1b", "--reduced",
                               "--device", "cpu", "--mesh", "2x2",
                               "--backend", "gloo"])
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


def test_audit_cli_on_a_mesh(tmp_path):
    """``python -m repro_torch.audit --mesh 2x2`` spawns four ranks; with
    ``force-allgather`` it exits 1 and its report names exactly the
    collective budget."""
    import json
    from repro_torch.audit import __main__ as cli

    rc = cli.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                   "cpu", "--mesh", "2x2", "--mutate", "force-allgather",
                   "--out", str(tmp_path)])
    assert rc == 1
    report = json.loads((tmp_path / "AUDIT_torch_tinyllama-1.1b-reduced-"
                         "mesh.json").read_text())
    assert [p["name"] for p in report["passes"] if not p["ok"]] == \
        ["collective-budget"]
    assert report["meta"]["mesh"] == "2x2"
