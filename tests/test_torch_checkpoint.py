"""The port's checkpoint layer (``checkpoint/``, ``core/paths.py::
keystr_leaves``, the leaf-wise arena views, ``Trainer.save`` /
``restore``) on the CPU, against the reference's ``repro.checkpoint`` and
``repro.train.Trainer``.

  * The reference's tests/test_checkpoint.py cases, rewritten for the
    port: roundtrip, None leaves, keep pruning, no partial directories,
    a missing directory, the controller state.
  * ``keystr_leaves`` spells and orders leaves as JAX does, and the two
    packages' Trainer states have the same key strings, shapes and dtypes
    for every optimizer.
  * Cross-package restore, both directions, at the MLP (6, 16, 40, 130)
    of tests/test_torch_trainer.py (its tolerances), arena + resident +
    streaming and ``arena=False``, preempted mid-window and on a jump
    step: every restored leaf is bit-identical to the writer's leaf-wise
    state, and both packages continue 20 steps from each checkpoint with
    losses within rtol 1e-5 until the next jump, 2e-3 after.
  * Format identity: a reference checkpoint restored and re-saved by the
    port has the same manifest.json and the same arrays (fp32, and bf16
    snapshots with the controller on).
  * In-port resume is bit-exact: ``fail_at_step`` and SIGTERM, mid-window
    and on a jump step, the controller on, mixed-m groups; a checkpoint
    without Grams rebuilds them; arena on/off and resident on/off restore
    into each other (dyadic trajectories, bit-exact).
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.paper_benches import _MLPModel
from repro.checkpoint import restore_checkpoint as j_restore
from repro.checkpoint import save_checkpoint as j_save
from repro.models.mlp_net import init_mlp as j_init
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import (latest_step, list_checkpoints,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import OptimizerConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import arena as tarena
from repro_torch.core import controller as C
from repro_torch.core import dmd as dmd_math
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import (by_path, keystr_leaves, map_keystrs,
                                    tree_map)
from repro_torch.core.schedule import GroupSchedule
from repro_torch.models.mlp_net import MLPModel
from repro_torch.train import Trainer, TrainState
from repro_torch.train.step import resident_enabled
from test_torch_trainer import (DMD, GATED, GATED_DMD, LEAVES, SIZES,
                                _cfgs, _data, _DotModel, _dot_acfg,
                                _int_batches)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    params = {"emb": torch.randn(8, 4, generator=g),
              "blk": {"w": torch.randn(4, 4, generator=g),
                      "b": torch.zeros(4)}}
    opt = {"m": tree_map(torch.zeros_like, params),
           "v": tree_map(torch.ones_like, params)}
    return TrainState(params, opt, torch.tensor(7, dtype=torch.int32), None)


def _np(x):
    """numpy of a tensor (bf16 as float32: exact) or of a JAX array."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _keyed(tree, jax_tree=False):
    """{key string: numpy array} of a port tree, or of a reference tree
    (``jax_tree``) through JAX's own flattening."""
    if jax_tree:
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        return {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    return {k: _np(x) for k, x in keystr_leaves(tree)}


def _assert_keyed_equal(a, b, msg=""):
    assert sorted(a) == sorted(b), msg
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (msg, k)
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{msg} {k}")


# -- the reference's tests/test_checkpoint.py, for the port ------------------

def test_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, st, 7)
    back = restore_checkpoint(tmp_path, _state(seed=1))
    assert back.step.dtype == torch.int32 and back.step.shape == ()
    assert int(back.step) == 7
    _assert_keyed_equal(_keyed(back), _keyed(st))


def test_none_leaves_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(tmp_path, st, 1)
    back = restore_checkpoint(tmp_path, st)
    assert back.dmd_buffers is None and back.controller is None


def test_keep_prunes_old(tmp_path):
    st = _state()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(tmp_path, st, s, keep=2)
    assert list_checkpoints(tmp_path) == [4, 5]
    assert latest_step(tmp_path) == 5


def test_no_partial_dirs_on_disk(tmp_path, monkeypatch):
    """A complete write leaves no ``.tmp_`` directory, and neither does a
    write that fails before its rename; the failed step is not listed."""
    st = _state()
    save_checkpoint(tmp_path, st, 3)
    assert [p for p in os.listdir(tmp_path) if p.startswith(".tmp_")] == []

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(tmp_path, st, 4)
    assert sorted(os.listdir(tmp_path)) == ["step_3"]
    assert latest_step(tmp_path) == 3


def test_restore_missing_returns_none(tmp_path):
    assert restore_checkpoint(tmp_path / "nothing", _state()) is None


def test_controller_state_roundtrip(tmp_path):
    """ControllerState rides in TrainState and round-trips; a checkpoint
    without controller leaves restores the template's fresh state."""
    g = (GroupSchedule(index=0, name="default", m=4, s=10, warmup_steps=0,
                       cooldown_steps=0, phase=0, relax=1.0, anneal=1.0),)
    ctrl = C.init_state(g)._replace(
        accepts=torch.tensor([3], dtype=torch.int32),
        s_eff=torch.tensor([2.5]))
    save_checkpoint(tmp_path, _state()._replace(controller=ctrl), 5)
    back = restore_checkpoint(tmp_path, _state()._replace(
        controller=C.init_state(g)))
    assert isinstance(back.controller, C.ControllerState)
    assert int(back.controller.accepts[0]) == 3
    assert float(back.controller.s_eff[0]) == 2.5
    save_checkpoint(tmp_path, _state(), 6)
    back2 = restore_checkpoint(tmp_path, _state()._replace(
        controller=C.init_state(g)))
    assert int(back2.controller.accepts[0]) == 0
    assert float(back2.controller.s_eff[0]) == 10.0


def test_bf16_and_int_leaves_roundtrip_through_the_reference(tmp_path):
    """bf16 is stored as its uint16 bits with logical dtype "bfloat16":
    the reference restores the port's file to the same bits and dtypes,
    and the port restores the reference's."""
    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn(5, 3, generator=g).to(torch.bfloat16),
            "q": torch.randint(-128, 127, (7,), generator=g,
                               dtype=torch.int8),
            "s": torch.tensor(4, dtype=torch.int32),
            "f": [torch.randn(2, generator=g), None]}
    save_checkpoint(tmp_path / "port", tree, 2)
    man = json.loads((tmp_path / "port" / "step_2" /
                      "manifest.json").read_text())
    assert man["leaves"]["['w']"] == {"key": "a3", "shape": [5, 3],
                                      "dtype": "bfloat16"}
    jtemplate = jax.tree_util.tree_map(
        lambda x: jnp.zeros(x.shape, jnp.dtype(str(x.dtype).split(".")[1])),
        {k: v for k, v in tree.items() if k != "f"})
    jtemplate["f"] = [jnp.zeros(2), None]
    jback = j_restore(tmp_path / "port", jtemplate)
    assert jback["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jback["w"]).view(np.uint16),
        tree["w"].view(torch.int16).numpy().view(np.uint16))
    j_save(tmp_path / "ref", jback, 2)
    back = restore_checkpoint(tmp_path / "ref", tree)
    for (p, x), (q, y) in zip(keystr_leaves(back), keystr_leaves(tree)):
        assert p == q and x.dtype == y.dtype and torch.equal(x, y), p
    assert back["f"][1] is None


# -- key strings -------------------------------------------------------------

def _mlp_acfgs(opt, ctrl=True):
    jac, tac = _cfgs(DMD, dict(GATED) if ctrl else {}, 1e-3)
    return (dataclasses.replace(jac, optimizer=dataclasses.replace(
                jac.optimizer, name=opt)),
            dataclasses.replace(tac, optimizer=dataclasses.replace(
                tac.optimizer, name=opt)))


@pytest.mark.parametrize("opt", ["adam", "adamw", "adam8bit", "adafactor",
                                 "momentum", "sgd"])
def test_keystr_leaves_match_jax_and_the_reference_state(opt):
    """keystr_leaves gives JAX's key strings in JAX's order (NamedTuple
    fields ``.name``, dict keys sorted, list items ``[i]``, None empty),
    and the port's leaf-wise Trainer state has the reference's key
    strings, shapes and dtypes: the manifests of the two packages name
    the same leaves."""
    jac, tac = _mlp_acfgs(opt)
    tr = Trainer(MLPModel(SIZES), tac, device="cpu")
    st = tr.acc.state_leafwise(tr.init_state())
    assert isinstance(st.controller, C.ControllerState)
    tree = {"z": st, "list": [st.controller, None, {"b": st.step,
                                                    "a": (st.step,)}],
            "none": None, "a": st.opt_state}
    mine = keystr_leaves(tree)
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert [p for p, _ in mine] == [jax.tree_util.keystr(p)
                                    for p, _ in flat]
    assert all(x is y for (_, x), (_, y) in zip(mine, flat))
    assert ".z.opt_state" not in {p for p, _ in mine}
    back = map_keystrs(lambda p, x: p, tree)
    assert back["z"].step == "['z'].step" and back["none"] is None
    assert back["list"][2]["a"] == ("['list'][2]['a'][0]",)

    jtr = JTrainer(_MLPModel(SIZES), jac)
    jst = jtr.acc.state_leafwise(jtr.init_state())
    want = {k: (v.shape, v.dtype) for k, v in _keyed(jst, True).items()}
    got = {k: (v.shape, v.dtype) for k, v in _keyed(st).items()}
    assert got == want


# -- cross-package restore ----------------------------------------------------

def _bomb(at):
    def on_m(t, m):
        if t == at:
            signal.raise_signal(signal.SIGTERM)
    return on_m


def _preempt_steps(acc, steps, after=0):
    """{"mid": a record step of a window that has a record already and does
    not close there, "jump": a jump step}, the first of each from step
    `after` on, read from the schedule."""
    mid = next(t for t in range(after, steps)
               if acc.should_record(t) and acc.slot(t) >= 1
               and not acc.apply_groups(t))
    jump = next(t for t in range(after, steps) if acc.apply_groups(t))
    return {"mid": mid, "jump": jump}


def _fit_losses(tr, steps, batch, **kw):
    """fit's per-step losses. Clears the preemption flag a SIGTERM left
    set (neither package's Trainer clears it), so a writer Trainer can
    fit again."""
    losses = []
    tr._preempted = False
    tr.fit(iter(lambda: batch, None), steps,
           on_metrics=lambda t, m: losses.append(float(m["loss"])), **kw)
    return np.asarray(losses)


@pytest.mark.parametrize("when", ["mid", "jump"])
@pytest.mark.parametrize("route", ["arena", "perleaf"])
def test_cross_package_restore_both_directions(tmp_path, route, when):
    """The reference writes checkpoint A and the port checkpoint B, each
    preempted by SIGTERM at the same step; the port restores A and the
    reference B, every leaf bit-identical to the writer's leaf-wise state;
    both manifests name the same leaves. Then each package continues 20
    steps from each checkpoint: the same start bits, so losses agree
    within rtol 1e-5 until the next jump and 2e-3 after."""
    dmd = dict(DMD, arena=route == "arena")
    jac, tac = _cfgs(dmd, {}, 1e-3)
    (X, Y), _, _ = _data()
    batch = {"x": X, "y": Y}
    p0 = jax.tree_util.tree_map(np.asarray,
                                j_init(jax.random.PRNGKey(0), SIZES))
    jtr = JTrainer(_MLPModel(SIZES), jac)
    ttr = Trainer(MLPModel(SIZES), tac, device="cpu")
    if route == "arena":
        assert resident_enabled(ttr.acc, ttr.acfg)
    at = _preempt_steps(ttr.acc, 30)[when]
    dirs = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    try:
        jtr.checkpoint_dir = dirs["ref"]
        jst = jtr.init_state()
        params = jax.tree_util.tree_map(jnp.asarray, p0)
        jst = jst._replace(params=params, opt_state=jtr.opt.init(params))
        jst = jtr.fit(iter(lambda: batch, None), 30, state=jst,
                      on_metrics=_bomb(at))
        ttr.checkpoint_dir = dirs["port"]
        tst = ttr.fit(iter(lambda: batch, None), 30,
                      state=ttr.init_state(params=params_from_jax(
                          p0, device="cpu")), on_metrics=_bomb(at))
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert int(jst.step) == int(tst.step) == at + 1
    assert latest_step(dirs["ref"]) == latest_step(dirs["port"]) == at + 1
    writer = {"ref": _keyed(jtr.acc.state_leafwise(jst), True),
              "port": _keyed(ttr.acc.state_leafwise(tst))}
    metas = [json.loads(open(os.path.join(d, f"step_{at + 1}",
                                          "manifest.json")).read())
             for d in dirs.values()]
    assert metas[0] == metas[1]
    assert len(metas[0]["leaves"]) == len(writer["ref"])

    ttr.checkpoint_dir = dirs["ref"]
    back = ttr.restore()
    if route == "arena":
        assert tarena.is_arena_state(back.dmd_buffers)
    _assert_keyed_equal(_keyed(ttr.acc.state_leafwise(back)), writer["ref"],
                        "ref -> port")
    jtr.checkpoint_dir = dirs["port"]
    _assert_keyed_equal(_keyed(jtr.acc.state_leafwise(jtr.restore()), True),
                        writer["port"], "port -> ref")

    steps = at + 1 + 20
    nxt = next(t for t in range(at + 1, steps) if ttr.acc.apply_groups(t))
    k = nxt - at                     # losses up to and including the jump
    for d in dirs.values():
        ttr.checkpoint_dir = jtr.checkpoint_dir = d
        tl = _fit_losses(ttr, steps, batch)
        jl = _fit_losses(jtr, steps, batch)
        assert len(tl) == len(jl) == 20
        np.testing.assert_allclose(tl[:k], jl[:k], rtol=1e-5)
        np.testing.assert_allclose(tl, jl, rtol=2e-3)


@pytest.mark.parametrize("case", ["fp32", "bf16-gated"])
def test_reference_checkpoint_resaved_by_the_port_is_identical(tmp_path,
                                                               case):
    """A reference checkpoint (written mid-window by its Trainer, arena
    and resident) restored into the port's Trainer and saved again has
    the same manifest.json, byte for byte, and the same arrays under
    every key."""
    bf16 = case == "bf16-gated"
    dmd = dict(DMD, snapshot_dtype="bfloat16", gram_upcast=False) \
        if bf16 else DMD
    ctrl = dict(GATED) if bf16 else {}
    jac, tac = _cfgs(dmd, ctrl, 1e-3)
    (X, Y), (Xv, Yv), _ = _data()
    val = {"x": Xv, "y": Yv} if ctrl else None
    jtr = JTrainer(_MLPModel(SIZES), jac, val_batch=val)
    ttr = Trainer(MLPModel(SIZES), tac, device="cpu", val_batch=val)
    at = _preempt_steps(ttr.acc, 30)["mid"] + 1
    jst = jtr.fit(iter(lambda: {"x": X, "y": Y}, None), at)
    if bf16:
        assert jst.controller is not None
    jtr.checkpoint_dir = str(tmp_path / "ref")
    jtr.save(jst, at)
    ttr.checkpoint_dir = str(tmp_path / "ref")
    st = ttr.restore()
    if bf16:
        assert st.dmd_buffers["__arena__"]["g0-float32"].dtype \
            == torch.bfloat16
    ttr.checkpoint_dir = str(tmp_path / "port")
    ttr.save(st, at)
    a, b = (tmp_path / d / f"step_{at}" for d in ("ref", "port"))
    assert (a / "manifest.json").read_text() == \
        (b / "manifest.json").read_text()
    with np.load(a / "arrays.npz") as za, np.load(b / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for key in za.files:
            assert za[key].dtype == zb[key].dtype, key
            np.testing.assert_array_equal(za[key], zb[key], err_msg=key)


# -- in-port resume ----------------------------------------------------------

def _port(dmd, ctrl=None, ckpt="", every=0, fail_at=None, rules=(),
          lr=1e-2):
    _, tac = _cfgs(dmd, ctrl or {}, lr, rules=rules)
    tac = dataclasses.replace(tac, train=dataclasses.replace(
        tac.train, checkpoint_every=every))
    (X, Y), (Xv, Yv), _ = _data()
    tr = Trainer(MLPModel(SIZES), tac, device="cpu", checkpoint_dir=ckpt,
                 fail_at_step=fail_at,
                 val_batch={"x": Xv, "y": Yv} if ctrl else None)
    return tr, {"x": X, "y": Y}


def _assert_states_equal(a, b, fields=("params", "opt_state", "step",
                                       "dmd_buffers", "dmd_gram",
                                       "controller")):
    for name in fields:
        _assert_keyed_equal(_keyed(getattr(a, name)),
                            _keyed(getattr(b, name)), name)


def test_failure_injection_and_bitexact_resume(tmp_path):
    """Checkpoints every 4 steps, a failure injected at step 8, a new
    Trainer resumes from step 8: the final state equals the uninterrupted
    run's bit for bit, and so do the losses after the restore."""
    tr_a, batch = _port(DMD)
    want = _fit_losses(tr_a, 24, batch)
    final_a = tr_a.fit(iter(lambda: batch, None), 24)
    tr_b, _ = _port(DMD, ckpt=str(tmp_path), every=4, fail_at=8)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr_b.fit(iter(lambda: batch, None), 24)
    assert list_checkpoints(tmp_path) == [4, 8]
    tr_c, _ = _port(DMD, ckpt=str(tmp_path))
    losses = _fit_losses(tr_c, 24, batch)
    np.testing.assert_array_equal(losses, want[8:])
    final_c = tr_c.fit(iter(lambda: batch, None), 24)
    _assert_states_equal(final_a, final_c)


@pytest.mark.parametrize("when", ["mid", "jump"])
def test_sigterm_preempt_resumes_controller_bitexact(tmp_path, when):
    """The gated controller on; SIGTERM inside on_metrics mid-window or on
    the exact jump step (the checkpoint then carries that jump's gate
    outcome): fit saves step + 1 and returns, a new Trainer resumes, and
    params, moments, buffers, Grams, the step and every controller field
    equal the uninterrupted run's, as do the losses after the restore."""
    steps = 40
    tr_a, batch = _port(GATED_DMD, GATED, lr=3e-3)
    at = _preempt_steps(tr_a.acc, steps)[when]
    if when == "jump":
        assert tr_a.acc.apply_groups(at)
    losses_a = []
    final_a = tr_a.fit(iter(lambda: batch, None), steps,
                       on_metrics=lambda t, m: losses_a.append(
                           float(m["loss"])))
    assert int(final_a.controller.accepts.sum()
               + final_a.controller.scaled.sum()
               + final_a.controller.rejects.sum()) >= 2
    tr_b, _ = _port(GATED_DMD, GATED, ckpt=str(tmp_path), lr=3e-3)
    try:
        st_b = tr_b.fit(iter(lambda: batch, None), steps,
                        on_metrics=_bomb(at))
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert int(st_b.step) == at + 1 and latest_step(tmp_path) == at + 1
    tr_c, _ = _port(GATED_DMD, GATED, ckpt=str(tmp_path), lr=3e-3)
    losses_c = _fit_losses(tr_c, steps, batch)
    np.testing.assert_array_equal(losses_c, losses_a[at + 1:])
    final_c = tr_c.fit(iter(lambda: batch, None), steps)
    _assert_states_equal(final_a, final_c)


MIXED = ({"name": "biases", "max_ndim": 1, "m": 3, "phase": 1,
          "cooldown_steps": 0},)


@pytest.mark.parametrize("route", ["arena", "perleaf"])
def test_mixed_m_mid_window_resume_bitexact(tmp_path, route):
    """Two schedule groups with different m and phases, checkpointed at a
    step where both sit mid-window: buffers and Grams restore at their
    per-group shapes and the resumed run is bit-exact."""
    dmd = dict(DMD, arena=route == "arena")
    tr_a, batch = _port(dmd, rules=MIXED)
    assert tr_a.acc.n_groups == 2
    assert {g.m for g in tr_a.acc.groups} == {3, 4}
    final_a = tr_a.fit(iter(lambda: batch, None), 24)
    acc = tr_a.acc
    at = next(t for t in range(8, 24)
              if all(g.slot(t - 1) >= 0 for g in acc.groups)
              and not acc.apply_groups(t - 1))
    tr_b, _ = _port(dmd, rules=MIXED, ckpt=str(tmp_path), every=at,
                    fail_at=at + 1)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr_b.fit(iter(lambda: batch, None), 24)
    assert latest_step(tmp_path) == at
    tr_c, _ = _port(dmd, rules=MIXED, ckpt=str(tmp_path))
    final_c = tr_c.fit(iter(lambda: batch, None), 24)
    _assert_states_equal(final_a, final_c)


def test_restore_rebuilds_grams_from_pre_streaming_checkpoint(tmp_path):
    """A checkpoint without Gram leaves (written before the streaming
    engine) must not resume on the template's all-zero Grams: restore
    rebuilds each from its restored buffer, exactly as gram_matrix
    does."""
    tr, batch = _port(DMD)
    at = _preempt_steps(tr.acc, 30)["mid"] + 1
    st = tr.fit(iter(lambda: batch, None), at)
    leaf = tr.acc.state_leafwise(st)
    assert leaf.dmd_gram is not None
    save_checkpoint(tmp_path, leaf._replace(dmd_gram=None), at)
    tr2, _ = _port(DMD, ckpt=str(tmp_path))
    back = tr2.restore()
    assert int(back.step) == at
    back = tr2.acc.state_leafwise(back)
    bufs, grams = by_path(back.dmd_buffers), by_path(back.dmd_gram)
    assert set(bufs) == set(grams) and bufs
    for path, buf in bufs.items():
        assert buf.any()
        want = dmd_math.gram_matrix(buf, anchor=tr2.acfg.dmd.anchor,
                                    upcast=tr2.acfg.dmd.gram_upcast)
        assert torch.equal(grams[path], want), path


def test_trainer_save_without_dir_and_resume_from_empty_dir(tmp_path):
    """No checkpoint_dir: save and restore do nothing. An empty directory:
    fit starts fresh and writes its checkpoints there; a second fit
    resumes from the newest."""
    tr, batch = _port(DMD)
    assert tr.save(tr.init_state(), 1) is None and tr.restore() is None
    tr, _ = _port(DMD, ckpt=str(tmp_path / "new"), every=5)
    assert tr.restore() is None
    st = tr.fit(iter(lambda: batch, None), 10)
    assert list_checkpoints(tmp_path / "new") == [5, 10]
    tr2, _ = _port(DMD, ckpt=str(tmp_path / "new"), every=5)
    assert int(tr2.restore().step) == 10
    st2 = tr2.fit(iter(lambda: batch, None), 12)
    assert int(st2.step) == 12 and int(st.step) == 10


# -- arena on/off and resident on/off -----------------------------------------

def _dot_trainer(arena=True, native=True, ckpt="", every=0):
    acfg = _dot_acfg(OptimizerConfig(name="momentum", lr=0.5, b1=0.5),
                     arena=arena, native=native)
    acfg = dataclasses.replace(acfg, train=dataclasses.replace(
        acfg.train, checkpoint_every=every))
    return Trainer(_DotModel(), acfg, device="cpu", checkpoint_dir=ckpt)


def test_checkpoint_interop_resident_and_perleaf(tmp_path):
    """A checkpoint written mid-fit by a resident run (the live state is
    the resident wrapper when save fires) restores into an arena=False
    run, and a per-leaf run's into a resident run; each continuation ends
    bit-equal to its own route's uninterrupted run (dyadic trajectory)."""
    batches = [{k: torch.as_tensor(v) for k, v in b.items()}
               for b in _int_batches(20)]
    oracle = {}
    for name, kw in (("leaf", dict(arena=False)), ("res", {})):
        tr = _dot_trainer(**kw)
        oracle[name] = tr.acc.state_leafwise(tr.fit(iter(batches), 16))
    for writer, reader in (("res", "leaf"), ("leaf", "res")):
        d = str(tmp_path / writer)
        kw = {"leaf": dict(arena=False), "res": {}}
        _dot_trainer(ckpt=d, every=5, **kw[writer]).fit(iter(batches), 8)
        tr = _dot_trainer(ckpt=d, **kw[reader])
        st = tr.restore()
        assert int(st.step) == 5
        assert tarena.is_arena_state(st.dmd_buffers) == (reader == "res")
        st = tr.fit(iter(batches[5:]), 16)
        _assert_states_equal(oracle[reader], tr.acc.state_leafwise(st),
                             ("params", "opt_state", "dmd_buffers",
                              "dmd_gram"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leafwise_views_roundtrip(dtype):
    """state_arenaize(state_leafwise(st)) restores every bucket's buffer
    (pad lanes zero) and Gram bit for bit, stacked leaves included; the
    leaf-wise buffers equal the per-leaf route's (arena=False) after the
    same dyadic steps, and the Grams too."""
    rng = np.random.default_rng(4)
    cfgs = {}
    for arena in (True, False):
        cfg = _dot_acfg(OptimizerConfig(name="sgd", lr=1.0),
                        arena=arena).dmd
        cfgs[arena] = dataclasses.replace(cfg, snapshot_dtype=dtype,
                                          gram_upcast=dtype == "float32")
    params = {k: torch.tensor(rng.integers(-4, 5, size=s),
                              dtype=torch.float32)
              for k, s in LEAVES.items()}
    deltas = [{k: torch.tensor(rng.integers(-2, 3, size=s),
                               dtype=torch.float32)
               for k, s in LEAVES.items()} for _ in range(5)]
    out = {}
    for arena, cfg in cfgs.items():
        acc = DMDAccelerator(cfg, stack_dims=_DotModel().param_stack_dims(),
                             device="cpu")
        bufs = acc.init(params)
        grams = acc.init_grams(bufs)
        p = params
        for t in range(5):
            p = {k: v + deltas[t][k] for k, v in p.items()}
            bufs, grams = acc.record(bufs, p, acc.slots(t), grams)
        st = TrainState(p, None, torch.tensor(5, dtype=torch.int32), bufs,
                        grams)
        out[arena] = (acc, st)
    acc, st = out[True]
    leaf = acc.state_leafwise(st)
    assert not tarena.is_arena_state(leaf.dmd_buffers)
    assert by_path(leaf.dmd_gram)["/stack"].shape == (3, 4, 4)
    _assert_states_equal(leaf, out[False][1], ("dmd_buffers", "dmd_gram"))
    back = acc.state_arenaize(leaf)
    for key, buf in st.dmd_buffers["__arena__"].items():
        got = back.dmd_buffers["__arena__"][key]
        assert got.dtype == buf.dtype and torch.equal(got, buf), key
        assert torch.equal(back.dmd_gram["__arena__"][key],
                           st.dmd_gram["__arena__"][key]), key
    assert acc.state_arenaize(back) is back
    off = out[False][0]
    assert off.state_arenaize(out[False][1]) is out[False][1]


def test_bucket_scope_grams_leafwise_raise():
    """In bucket scope ``grams_leafwise`` rebuilds each leaf's per-system
    Grams from the buffers (K3's twin with the bucket's real table): on a
    dyadic run they equal a leaf-scope run's carried Grams bit for bit,
    and ``grams_from_leafwise`` sums them back to the bucket Gram. Without
    the buffers it raises ValueError, as the reference does."""
    opt = OptimizerConfig(name="momentum", lr=0.5, b1=0.5)
    batches = _int_batches(16)
    runs = {}
    for scope in ("leaf", "bucket"):
        acfg = _dot_acfg(opt)
        acfg = dataclasses.replace(acfg, dmd=dataclasses.replace(
            acfg.dmd, scope=scope))
        tr = Trainer(_DotModel(), acfg, device="cpu")
        # the first window completes at step 5, before any jump moves the
        # params off the dyadic grid
        runs[scope] = (tr, tr.fit(iter(batches), 6))
    (tr_l, st_l), (tr_b, st_b) = runs["leaf"], runs["bucket"]
    table = tr_b.acc.arena_for(st_b.params)
    agrams = tarena.split_state(st_b.dmd_gram)[0]
    arenas = tarena.split_state(st_b.dmd_buffers)[0]
    got = tarena.grams_leafwise(table, agrams, tr_b.acfg.dmd, arenas)
    want = tarena.grams_leafwise(table, tarena.split_state(st_l.dmd_gram)[0])
    assert sorted(got) == sorted(want)
    for path in want:
        assert torch.equal(got[path], want[path]), path
    back = tarena.grams_from_leafwise(table, got, scope="bucket")
    for key, g in agrams.items():
        assert torch.equal(back[key], g), key
    with pytest.raises(ValueError, match="buffers"):
        tarena.grams_leafwise(table, agrams, tr_b.acfg.dmd)


def _scope_runs(scope, steps=8):
    """The reference's ``_run_cycles`` (tests/test_arena.py) through both
    accelerators at `scope` on integer leaves, rounded after each jump;
    returns {"ref"/"port": (accelerator, TrainState)}."""
    from repro.configs.base import DMDConfig as JCfg
    from repro.core import DMDAccelerator as JAcc
    from repro.train.state import TrainState as JState
    from repro_torch.configs.base import DMDConfig
    rng = np.random.default_rng(41)
    sizes = {"a": (40,), "b": (10, 13), "c": (333,)}
    params = {k: rng.integers(-8, 9, size=v).astype(np.float32)
              for k, v in sizes.items()}
    deltas = {k: rng.integers(-2, 3, size=v).astype(np.float32)
              for k, v in sizes.items()}
    kw = dict(m=4, s=5, warmup_steps=0, cooldown_steps=0, tol=1e-6,
              scope=scope)
    out = {}
    for name, acc, put, rnd, State in (
            ("ref", JAcc(JCfg(**kw)), jnp.asarray, jnp.round, JState),
            ("port", DMDAccelerator(DMDConfig(**kw), device="cpu"),
             torch.tensor, torch.round, TrainState)):
        p = {k: put(v) for k, v in params.items()}
        bufs = acc.init(p)
        grams = acc.init_grams(bufs)
        for t in range(steps):
            p = {k: v + put(deltas[k]) for k, v in p.items()}
            bufs, grams = acc.record(bufs, p, acc.slots(t), grams)
            if acc.should_apply(t):
                p, _ = acc.apply(dict(p), bufs, grams=grams, step=t)
                p = {k: rnd(v) for k, v in p.items()}
        out[name] = (acc, State(p, None, put(np.int32(steps)), bufs, grams))
    return out


@pytest.mark.parametrize("writer", ["ref", "port"])
@pytest.mark.parametrize("scopes", [("bucket", "leaf"), ("leaf", "bucket")])
def test_checkpoint_interop_bucket_and_leaf_scope(tmp_path, scopes, writer):
    """tests/test_arena.py:588 across the packages: a checkpoint written at
    one scope by either package restores into the port at the other
    scope. On disk it is leaf-wise in both scopes (bucket scope: K3
    rebuilds the per-system Grams at save), so the restored, re-packed
    buffers and Grams equal the reader's own run at its scope bit for bit
    (integer data, a window-complete point); the reference also reads the
    port's."""
    w_scope, r_scope = scopes
    w_acc, w_st = _scope_runs(w_scope)[writer]
    readers = _scope_runs(r_scope)
    if writer == "ref":
        j_save(tmp_path, w_acc.state_leafwise(w_st), 8)
    else:
        save_checkpoint(tmp_path, w_acc.state_leafwise(w_st), 8)
    acc, own = readers["port"]
    tmpl = TrainState(own.params, None, torch.tensor(0, dtype=torch.int32),
                      acc.init(own.params), None)
    tmpl = tmpl._replace(dmd_gram=acc.init_grams(tmpl.dmd_buffers))
    back = acc.state_arenaize(restore_checkpoint(tmp_path,
                                                 acc.state_leafwise(tmpl)))
    for key, g in own.dmd_gram["__arena__"].items():
        got = back.dmd_gram["__arena__"][key]
        assert got.shape == g.shape and torch.equal(got, g), key
        assert torch.equal(back.dmd_buffers["__arena__"][key],
                           own.dmd_buffers["__arena__"][key]), key
    for k, v in own.params.items():
        assert torch.equal(back.params[k], v), k
    if writer == "port":
        jacc, jown = readers["ref"]
        jt = jown._replace(step=jnp.asarray(0, jnp.int32))
        jback = jacc.state_arenaize(j_restore(tmp_path,
                                              jacc.state_leafwise(jt)))
        for key, g in jown.dmd_gram["__arena__"].items():
            np.testing.assert_array_equal(
                np.asarray(jback.dmd_gram["__arena__"][key]),
                np.asarray(g), key)


@pytest.mark.parametrize("when", ["mid", "jump"])
def test_bucket_scope_eig_sigterm_resume_bitexact(tmp_path, when):
    """The paper's eig mode at bucket scope on float data, preempted by
    SIGTERM mid-window (a record past the anchor already taken) or on a
    jump step: the resumed run's losses and final state equal the
    uninterrupted run's bit for bit. The checkpoint carries the bucket's
    Grams leaf-wise (K3's rebuild, summed back on restore), which round
    differently from the carried K1 rows; the restore rewrites the
    current window's rows with K1 in the order the stream wrote them
    (``arena.restream_grams``), and the later ones are rewritten by the
    records before the next jump."""
    dmd = dict(DMD, scope="bucket", mode="eig")
    steps = 30
    tr_a, batch = _port(dmd)
    at = _preempt_steps(tr_a.acc, steps, after=10)[when]
    want = _fit_losses(tr_a, steps, batch)
    final_a = tr_a.fit(iter(lambda: batch, None), steps)
    tr_b, _ = _port(dmd, ckpt=str(tmp_path))
    try:
        st_b = tr_b.fit(iter(lambda: batch, None), steps,
                        on_metrics=_bomb(at))
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    assert int(st_b.step) == at + 1
    tr_c, _ = _port(dmd, ckpt=str(tmp_path))
    np.testing.assert_array_equal(_fit_losses(tr_c, steps, batch),
                                  want[at + 1:])
    final_c = tr_c.fit(iter(lambda: batch, None), steps)
    _assert_states_equal(final_a, final_c)


def test_train_mlp_ckpt_resumes(tmp_path, capsys):
    """``launch/train_mlp.py --ckpt DIR`` at the paper MLP's full width on
    the CPU: checkpoints every 50 steps, and a rerun on the same DIR
    resumes from the newest."""
    from repro_torch.launch import train_mlp
    d = str(tmp_path / "ck")
    train_mlp.main(["--device", "cpu", "--rows", "8", "--steps", "51",
                    "--ckpt", d])
    assert list_checkpoints(d) == [50]
    assert "steps 0 to 51" in capsys.readouterr().out
    train_mlp.main(["--device", "cpu", "--rows", "8", "--steps", "53",
                    "--ckpt", d])
    assert "steps 50 to 53" in capsys.readouterr().out


@pytest.mark.parametrize("anchor", ["first", "none"])
def test_restream_grams_rebuilds_the_current_window_rows(anchor):
    """``arena.restream_grams`` on a bucket-scope state mid-window: from a
    Gram whose every entry is NaN it rebuilds, bit for bit, the carried
    entries among the slots the window has written (the ones the next
    jump reads and no later record rewrites); after a jump step, in
    cooldown or in leaf scope it touches nothing."""
    dmd = dict(DMD, scope="bucket", mode="eig", anchor=anchor)
    tr, batch = _port(dmd)
    acc = tr.acc
    mid = _preempt_steps(acc, 30, after=10)["mid"] + 1   # next step to run
    k = acc.slot(mid - 1)
    assert k >= 1
    st = tr.fit(iter(lambda: batch, None), mid)
    table = acc.arena_for(st.params)
    arenas = tarena.split_state(st.dmd_buffers)[0]
    carried = tarena.split_state(st.dmd_gram)[0]
    junk = {key: torch.full_like(g, float("nan"))
            for key, g in carried.items()}
    tarena.restream_grams(junk, arenas, table, tr.acfg.dmd, mid)
    for key, g in carried.items():
        assert torch.equal(junk[key][:, :k + 1, :k + 1],
                           g[:, :k + 1, :k + 1]), key
    jump = _preempt_steps(acc, 30, after=10)["jump"] + 1
    cool = next(t for t in range(jump, 30) if acc.slot(t - 1) < 0)
    leaf_cfg = dataclasses.replace(tr.acfg.dmd, scope="leaf")
    for step, cfg in ((jump, tr.acfg.dmd), (cool, tr.acfg.dmd),
                      (mid, leaf_cfg)):
        junk = {key: torch.full_like(g, float("nan"))
                for key, g in carried.items()}
        tarena.restream_grams(junk, arenas, table, cfg, step)
        assert all(torch.isnan(g).all() for g in junk.values()), step