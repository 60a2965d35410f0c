"""The port's Trainer path (``train/{loop,step,state}.py``, residency, the
loss-gated controller, the differentiable combines) against the
reference's ``repro.train.Trainer`` on the CPU, at small size: the MLP
below, m 4, s <= 10, a few dozen steps, the numpy teacher of
``data/synthetic.py``. The reference's init is injected through
``convert.params_from_jax``; both Trainers see the same batches.

The MLP (6, 16, 40, 130) on 64 rows: at 4 outputs the m = 4 windows of
the smallest leaves sit at the rank mask's fp32 noise floor and the two
packages' eigensolvers pick different ranks.

Tolerances: until the first jump the per-step losses agree to rtol 1e-5
(fp32 summation order in the matmuls); each jump passes that noise
through an eigensolve and an s-step matrix power, so from then on losses
and params agree to rtol 2e-3 (the paper-loop parity tests' bound), and
the gate's decisions (the outcome sequence) must be identical. Dyadic
trajectories (integer batches, momentum with beta = lr = 0.5) are
bit-exact wherever the reference pins bit-exactness: across the resident,
pack-copy and per-leaf routes, and against the reference before the
first jump. Controller counters and horizons are exact; relax_eff and
ridge_eff agree to rtol 1e-6."""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.paper_benches import _MLPModel
from repro.configs.base import ArchConfig as JArch
from repro.configs.base import DMDConfig as JCfg
from repro.configs.base import DMDControllerConfig as JCtrl
from repro.configs.base import ModelConfig as JModel
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import ParallelConfig as JPar
from repro.configs.base import TrainConfig as JTrain
from repro.core import DMDAccelerator as JAcc
from repro.core import arena as jarena
from repro.core.schedule import DMDGroupRule as JRule
from repro.kernels import arena as jka
from repro.kernels import ref as jkref
from repro.models.mlp_net import init_mlp as j_init
from repro.models.mlp_net import mse_loss as j_mse
from repro.train import Trainer as JTrainer
from repro_torch.configs.base import (ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      TrainConfig)
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.convert import params_from_jax
from repro_torch.core import arena as tarena
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import leaves_with_paths
from repro_torch.core.schedule import DMDGroupRule
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.kernels import arena as ka
from repro_torch.kernels import combine as kc
from repro_torch.models.mlp_net import MLPModel, mse_loss
from repro_torch.train import Trainer, TrainState
from repro_torch.train.step import (RESIDENT_OPTIMIZERS, resident_enabled,
                                    state_resident, state_unresident)

SIZES = (6, 16, 40, 130)
N, NV = 64, 32                       # training rows, validation rows


def _data(seed=0):
    X, Y = synthetic_regression(seed=seed, n=N + 2 * NV, n_out=SIZES[-1])
    return (X[:N], Y[:N]), (X[N:N + NV], Y[N:N + NV]), (X[N + NV:],
                                                          Y[N + NV:])


def _cfgs(dmd: dict, ctrl: dict, lr: float, opt: str = "adam",
          ga: int = 1, rules=()):
    """(reference ArchConfig, port ArchConfig) mirrored field by field."""
    out = []
    for Arch, Model, Cfg, Ctrl, Opt, Par, Train, Rule in (
            (JArch, JModel, JCfg, JCtrl, JOpt, JPar, JTrain, JRule),
            (ArchConfig, ModelConfig, DMDConfig, DMDControllerConfig,
             OptimizerConfig, ParallelConfig, TrainConfig, DMDGroupRule)):
        out.append(Arch(
            model=Model(name="mlp", family="mlp"),
            dmd=Cfg(**dmd, groups=tuple(Rule(**r) for r in rules),
                    controller=Ctrl(**ctrl)),
            optimizer=Opt(name=opt, lr=lr), parallel=Par(grad_accum=ga),
            train=Train(global_batch=N, seq_len=1), shapes=()))
    return out


def _run_both(dmd, ctrl, lr, steps, *, opt="adam", ga=1, rules=(),
              seed=0):
    """Both Trainers from the reference's init on the same batches.
    Returns {"ref"/"port": (final state, losses, outcomes, metrics)}."""
    (X, Y), (Xv, Yv), _ = _data(seed)
    p0 = jax.tree_util.tree_map(np.asarray,
                                j_init(jax.random.PRNGKey(seed), SIZES))
    jac, tac = _cfgs(dmd, ctrl, lr, opt, ga, rules)
    gated = bool(ctrl.get("enabled"))
    val = {"x": Xv, "y": Yv} if gated else None
    out = {}
    for name in ("ref", "port"):
        losses, outcomes, ranks = [], [], []

        def on_m(t, m, losses=losses, outcomes=outcomes, ranks=ranks):
            losses.append(float(m["loss"]))
            if "ctrl_outcome" in m:
                outcomes.append(int(m["ctrl_outcome"]))
            if "mean_rank" in m:
                ranks.append(float(m["mean_rank"]))
        if name == "ref":
            tr = JTrainer(_MLPModel(SIZES), jac, val_batch=val)
            st = tr.init_state()
            params = jax.tree_util.tree_map(jnp.asarray, p0)
            st = st._replace(params=params, opt_state=tr.opt.init(params))
        else:
            tr = Trainer(MLPModel(SIZES), tac, val_batch=val, device="cpu")
            st = tr.init_state(params=params_from_jax(p0, device="cpu"))
        st = tr.fit(iter(lambda: {"x": X, "y": Y}, None), steps, state=st,
                    on_metrics=on_m)
        out[name] = (tr, st, np.asarray(losses), outcomes, ranks)
    return out


def _first_jump(tr, steps):
    return next((t for t in range(steps) if tr.acc.apply_groups(t)), steps)


def _check_losses(out, steps):
    _, _, jl, _, _ = out["ref"]
    tr, _, tl, _, _ = out["port"]
    k = _first_jump(tr, steps) + 1           # losses before the first jump
    np.testing.assert_allclose(tl[:k], jl[:k], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)


def _check_params(out, rtol=2e-3):
    """The final params of both Trainers give the same held-out loss
    (rtol 2e-3): the jumps amplify fp32 noise most in the smallest
    leaves (the biases), which the loss weighs least."""
    _, _, (Xt, Yt) = _data()
    want = float(j_mse(out["ref"][1].params, jnp.asarray(Xt),
                          jnp.asarray(Yt)))
    got = float(mse_loss(out["port"][1].params, torch.tensor(Xt),
                         torch.tensor(Yt)))
    assert got == pytest.approx(want, rel=rtol)


DMD = dict(m=4, s=5, warmup_steps=5, cooldown_steps=2, arena_block_n=128,
           tol=1e-4)
# biases in their own group, jumping between the matrices' jumps and
# keeping their moments (the paper-loop parity test's staggered schedule)
TWO_GROUPS = ({"name": "biases", "max_ndim": 1, "m": 4, "phase": 3,
               "cooldown_steps": 2, "s": 4, "reset_opt": False},)


@pytest.mark.parametrize("route", ["arena", "perleaf", "arena-2groups",
                                   "perleaf-2groups", "arena-recompute",
                                   "packed"])
def test_ungated_trainer_matches_reference(route):
    dmd = dict(DMD, arena=not route.startswith("perleaf"),
               streaming_gram=not route.endswith("recompute"),
               arena_native=route != "packed")
    rules = TWO_GROUPS if route.endswith("2groups") else ()
    out = _run_both(dmd, {}, 1e-3, 30, rules=rules)
    tr, st = out["port"][0], out["port"][1]
    if route == "arena":
        assert resident_enabled(tr.acc, tr.acfg)
    assert not tarena.is_arena_state(st.params)          # unresident
    assert int(st.step) == 30
    if rules:
        assert tr.acc.n_groups == 2
        assert any(tr.acc.apply_groups(t) == (1,) for t in range(30))
    _check_losses(out, 30)
    _check_params(out)
    # the first jump's mean rank; later ones sit at the tol mask's fp32
    # noise floor, where the two eigensolvers may keep different ranks
    assert len(out["port"][4]) == len(out["ref"][4]) >= 3
    assert out["port"][4][0] == out["ref"][4][0]


def test_grad_accum_matches_reference():
    out = _run_both(DMD, {}, 1e-3, 20, ga=4)
    _check_losses(out, 20)
    _check_params(out)


GATED = dict(enabled=True, eval_rows=0, val_gate=True,
             shrink_levels=(0.5, 0.25))
GATED_DMD = dict(DMD, s=10)
# the outcome sequence both Trainers reach on GATED_DMD at lr 3e-3 (jumps
# at steps 10, 16, ..., 58): every outcome of the gate
PINNED = [2, 2, 2, 1, 0, 2, 0, 2, 2]


@pytest.mark.parametrize("route", ["arena", "perleaf"])
def test_gated_trainer_outcomes_pinned(route):
    dmd = dict(GATED_DMD, arena=route == "arena")
    out = _run_both(dmd, GATED, 3e-3, 60)
    assert out["ref"][3] == PINNED
    assert out["port"][3] == PINNED
    assert set(PINNED) == {0, 1, 2}
    jc, tc = out["ref"][1].controller, out["port"][1].controller
    for name in ("accepts", "scaled", "rejects", "streak", "s_eff"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    for name in ("relax_eff", "ridge_eff"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-6)
    _check_losses(out, 60)
    _check_params(out)


@pytest.mark.parametrize("route", ["arena", "perleaf"])
def test_meta_tuned_knobs_match_reference(route):
    """meta_lr > 0: the gate loss backpropagated through the jump (the
    combine's backward is K1's / K4's twin here) moves relax_eff and
    ridge_eff exactly as the reference's jax.grad does."""
    dmd = dict(GATED_DMD, arena=route == "arena")
    ctrl = dict(GATED, meta_lr=0.25, ridge=0.01, ridge_max=0.1)
    out = _run_both(dmd, ctrl, 3e-3, 40)
    assert out["port"][3] == out["ref"][3]
    jc, tc = out["ref"][1].controller, out["port"][1].controller
    for name in ("relax_eff", "ridge_eff"):
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), rtol=1e-6,
                                   err_msg=name)
    # the knobs moved off their init, inside their bands
    assert float(tc.ridge_eff[0]) != pytest.approx(0.01)
    assert 0.0 <= float(tc.ridge_eff[0]) <= 0.1
    assert 0.125 <= float(tc.relax_eff[0]) <= 1.0
    _check_losses(out, 40)


# -- bucket scope and eig mode (DESIGN.md §9; the paper's classic DMD) -------

@pytest.mark.parametrize("dmd", [
    dict(scope="bucket"),
    dict(mode="eig"),
    dict(scope="bucket", mode="eig"),
    dict(scope="bucket", mode="eig", arena_native=False),
    dict(mode="eig", arena=False),
    dict(scope="bucket", streaming_gram=False),
], ids=["bucket", "eig", "bucket-eig", "bucket-eig-packed", "perleaf-eig",
        "bucket-recompute"])
def test_trainer_scope_and_mode_match_reference(dmd):
    """The Trainer at bucket scope and in eig mode against the
    reference's: losses to rtol 1e-5 up to the first jump and 2e-3 after
    it, the held-out loss of the final params to 2e-3, the first jump's
    mean rank equal. Bucket scope solves one system per bucket (the MLP
    packs into one bucket: mean rank over its segments is the one rank).
    ``clamp_eigs`` is held function by function in test_torch_dmd.py, not
    here: whether a mode's |lambda| lands above the clamp's 1 + 1e-3 edge
    follows the fp32 noise, and a Trainer run with it moves by 1.5e-2
    between the packages after three jumps (measured)."""
    out = _run_both(dict(DMD, **dmd), {}, 1e-3, 30)
    tr, st = out["port"][0], out["port"][1]
    assert int(st.step) == 30 and not tarena.is_arena_state(st.params)
    if dmd.get("scope") == "bucket":
        grams = st.dmd_gram if dmd.get("streaming_gram", True) else None
        if grams is not None:
            assert [tuple(g.shape) for g in grams["__arena__"].values()] \
                == [(1, 4, 4)]
        assert "bucket" in tr.acc.plan_table().splitlines()[1]
    _check_losses(out, 30)
    _check_params(out)
    assert len(out["port"][4]) == len(out["ref"][4]) >= 3
    assert out["port"][4][0] == out["ref"][4][0]


@pytest.mark.parametrize("scope", ["leaf", "bucket"])
def test_gated_trainer_in_eig_mode_matches_reference(scope):
    """The loss-gated controller (meta-tuning off) in eig mode: the same
    outcome sequence and controller counters as the reference's, losses
    as above."""
    dmd = dict(GATED_DMD, mode="eig", scope=scope)
    out = _run_both(dmd, GATED, 3e-3, 40)
    assert out["port"][3] == out["ref"][3] and len(out["port"][3]) >= 4
    jc, tc = out["ref"][1].controller, out["port"][1].controller
    for name in ("accepts", "scaled", "rejects", "streak", "s_eff"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)), name)
    _check_losses(out, 40)


def test_meta_tuning_in_eig_mode_raises_as_the_reference():
    """meta_lr > 0 differentiates through the jump; the host eig has no
    derivative, so both packages refuse it when the jump step is built."""
    jac, tac = _cfgs(dict(GATED_DMD, mode="eig"),
                     dict(GATED, meta_lr=0.25), 3e-3)
    (_, _), (Xv, Yv), _ = _data()
    val = {"x": Xv, "y": Yv}
    with pytest.raises(ValueError, match="meta_lr > 0.*matpow"):
        JTrainer(_MLPModel(SIZES), jac, val_batch=val)
    with pytest.raises(ValueError, match="meta_lr > 0.*matpow"):
        Trainer(MLPModel(SIZES), tac, val_batch=val, device="cpu")


def _port_trainer(dmd, ctrl, lr=1e-2, opt="adam", rules=()):
    _, tac = _cfgs(dmd, ctrl, lr, opt, 1, rules)
    (X, Y), (Xv, Yv), _ = _data()
    tr = Trainer(MLPModel(SIZES), tac, device="cpu",
                 val_batch={"x": Xv, "y": Yv} if ctrl.get("enabled")
                 else None)
    return tr, X, Y


def _leaves(tree):
    return [x for _, x in leaves_with_paths(tree)]


def _assert_equal(a, b, msg):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb), msg
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"{msg}[{i}]"


@pytest.mark.parametrize("route", ["arena", "perleaf"])
def test_rollback_oracle(route):
    """accept_tol = -1: no positive loss passes the gate, so every jump is
    REJECTed, and the final state is bit-identical to a run that never
    dispatched a jump (train steps only): params, moments, buffers, Grams.
    One rejected jump step, called directly, leaves params and moments
    bit-identical to the pre-jump state."""
    ctrl = dict(GATED, accept_tol=-1.0)
    dmd = dict(DMD, arena=route == "arena")
    tr, X, Y = _port_trainer(dmd, ctrl)
    batches = iter(lambda: {"x": X, "y": Y}, None)
    outcomes = []
    st = tr.fit(batches, 24, on_metrics=lambda t, m: outcomes.append(
        m.get("ctrl_outcome")))
    outcomes = [o for o in outcomes if o is not None]
    assert outcomes == [0, 0, 0]
    assert int(st.controller.rejects.sum()) == 3

    oracle, _, _ = _port_trainer(dmd, ctrl)
    o = state_resident(oracle.acc, oracle.acfg, oracle.init_state())
    batch = oracle._to_device({"x": X, "y": Y})
    for t in range(24):
        o, _ = oracle.train_step(o, batch, oracle.acc.slots(t))
    o = state_unresident(oracle.acc, o)
    for name in ("params", "opt_state", "dmd_buffers", "dmd_gram"):
        _assert_equal(getattr(st, name), getattr(o, name), name)

    # one rejected jump, directly: nothing written
    res = state_resident(tr.acc, tr.acfg, st)
    before = [x.clone() for x in _leaves(res.params) + _leaves(res.opt_state)]
    res2, info = tr.dmd_step(res, tr.acc.relax_vector(22), tr.val_batch,
                             groups=(0,))
    assert info["ctrl_outcome"] == 0
    after = _leaves(res2.params) + _leaves(res2.opt_state)
    assert all(torch.equal(x, y) for x, y in zip(before, after))


def test_gate_batch_rules_and_publish():
    """The gate never draws from the training iterator; without a gate
    batch the controller refuses to run; eval_rows is clamped to the
    batch; on_publish fires after every jump the gate did not reject,
    with the per-leaf params and the next step's number."""
    tr, X, Y = _port_trainer(DMD, dict(GATED, eval_rows=999,
                                       val_gate=False))
    calls = {"n": 0}

    def gen():
        while True:
            calls["n"] += 1
            yield {"x": X, "y": Y}
    published, outcomes = [], {}

    def on_pub(params, version):
        assert not tarena.is_arena_state(params)
        assert set(params) == {"l0", "l1", "l2"}
        published.append(version)
    tr.on_publish = on_pub
    tr.fit(gen(), 30, on_metrics=lambda t, m: outcomes.__setitem__(
        t, m["ctrl_outcome"]) if "ctrl_outcome" in m else None)
    assert calls["n"] == 30
    assert published == [t + 1 for t, o in sorted(outcomes.items())
                         if o != 0]
    tr2, X, Y = _port_trainer(DMD, dict(GATED, val_gate=False))
    tr2.val_batch = None
    with pytest.raises(ValueError, match="gate batch"):
        tr2.fit(iter(lambda: {"x": X, "y": Y}, None), 10)


def test_entry_points_and_unported_raise(tmp_path):
    if not torch.cuda.is_available():
        _, tac = _cfgs(DMD, {}, 1e-3)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(MLPModel(PAPER_SIZES), tac)
    tr, X, Y = _port_trainer(DMD, {})
    tr.fail_at_step = 3
    with pytest.raises(RuntimeError, match="injected failure at step 3"):
        tr.fit(iter(lambda: {"x": X, "y": Y}, None), 10)
    # with a checkpoint_dir the first fit starts fresh on the empty dir and
    # writes step_2; a second fit resumes from it
    _, tac = _cfgs(DMD, {}, 1e-3)
    tac = dataclasses.replace(tac, train=dataclasses.replace(
        tac.train, checkpoint_every=2))
    (X, Y), _, _ = _data()
    tr = Trainer(MLPModel(SIZES), tac, device="cpu",
                 checkpoint_dir=str(tmp_path))
    st = tr.fit(iter(lambda: {"x": X, "y": Y}, None), 2)
    assert int(st.step) == 2 and os.listdir(tmp_path) == ["step_2"]
    steps = []
    st2 = Trainer(MLPModel(SIZES), tac, device="cpu",
                  checkpoint_dir=str(tmp_path)).fit(
        iter(lambda: {"x": X, "y": Y}, None), 4,
        on_metrics=lambda t, m: steps.append(t))
    assert steps == [2, 3] and int(st2.step) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_4"]
    tr, X, Y = _port_trainer(DMD, {})
    assert tr.save(tr.init_state(), 1) is None and tr.restore() is None
    st = tr.init_state()
    assert isinstance(st, TrainState) and st.step.dtype == torch.int32
    assert "adafactor" not in RESIDENT_OPTIMIZERS


# -- residency ---------------------------------------------------------------

LEAVES = {"w": (16, 13), "b": (7,), "v": (130,), "stack": (3, 5, 6)}
STACK = {"w": 0, "b": 0, "v": 0, "stack": 1}     # the reference's pytree
T_STACK = {"/" + k: v for k, v in STACK.items()}   # the port's, by path


class _DotModel:
    """loss = sum over leaves of <params[k], batch[k]>: the gradient IS the
    batch, so integer batches and momentum(beta = lr = 0.5) keep every
    snapshot dyadic and every fp32 Gram sum exact in any order (the
    reference's tests/test_arena_resident.py model)."""

    def init(self, generator):
        rng = np.random.default_rng(0)
        return {k: torch.tensor(rng.integers(-4, 5, size=s),
                                dtype=torch.float32)
                for k, s in LEAVES.items()}

    def loss(self, params, batch):
        return sum(torch.vdot(params[k].reshape(-1), batch[k].reshape(-1))
                   for k in LEAVES), None

    def param_stack_dims(self):
        return T_STACK


def _int_batches(n, seed=1):
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(-2, 3, size=s).astype(np.float32)
             for k, s in LEAVES.items()} for _ in range(n)]


def _float_batches(n, seed=2):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(size=s).astype(np.float32)
             for k, s in LEAVES.items()} for _ in range(n)]


def _dot_acfg(opt, *, native=True, arena=True, controller=False,
              groups=()):
    return ArchConfig(
        model=ModelConfig(name="dot", family="mlp"),
        dmd=DMDConfig(m=4, s=8, tol=1e-6, warmup_steps=2, cooldown_steps=0,
                      arena=arena, arena_native=native, groups=groups,
                      controller=DMDControllerConfig(enabled=controller,
                                                     eval_rows=0)),
        optimizer=opt, train=TrainConfig(global_batch=8, seq_len=1),
        shapes=())


def _dot_fit(acfg, batches, steps, eval_batch=None):
    tr = Trainer(_DotModel(), acfg, device="cpu")
    return tr, tr.fit(iter(batches), steps, eval_batch=eval_batch)


def _leafwise_bufs(tr, st):
    """Snapshot buffers and Grams per leaf path, from either layout: the
    arena's per-system rows unpacked by the checkpoint views
    (``arena.buffers_leafwise`` / ``grams_leafwise``)."""
    bufs, grams = {}, {}
    b, g = st.dmd_buffers, st.dmd_gram
    if tarena.is_arena_state(b):
        (arenas, leaf), (agrams, lgrams) = (tarena.split_state(b),
                                            tarena.split_state(g))
        table = tr.acc.arena_for(st.params)
        bufs = tarena.buffers_leafwise(table, arenas)
        grams = tarena.grams_leafwise(table, agrams)
        b, g = leaf, lgrams
    bufs.update(dict(leaves_with_paths(b)))
    grams.update(dict(leaves_with_paths(g)))
    return bufs, grams


def test_three_route_full_cycle_bitexact():
    """Resident vs pack-copy vs per-leaf through Trainer.fit with the gate
    on, a dyadic trajectory through the first gated cycle (jump at step
    5): params, moments, buffers, Grams and controller state bit-equal on
    all three routes."""
    batches = _int_batches(16)
    eval_batch = _int_batches(1, seed=9)[0]
    opt = OptimizerConfig(name="momentum", lr=0.5, b1=0.5)
    runs = {}
    for name, kw in (("resident", dict(native=True)),
                     ("packed", dict(native=False)),
                     ("per_leaf", dict(arena=False))):
        acfg = _dot_acfg(opt, controller=True, **kw)
        tr, st = _dot_fit(acfg, batches, 6, eval_batch)
        if name == "resident":
            assert resident_enabled(tr.acc, acfg)
        runs[name] = (tr, st)
    tr0, ref = runs["resident"]
    assert int(ref.controller.accepts.sum() + ref.controller.scaled.sum()
               + ref.controller.rejects.sum()) == 1
    rb, rg = _leafwise_bufs(tr0, ref)
    for other in ("packed", "per_leaf"):
        tr, st = runs[other]
        _assert_equal(ref.params, st.params, f"params:{other}")
        _assert_equal(ref.opt_state, st.opt_state, f"moments:{other}")
        _assert_equal(ref.controller, st.controller, f"ctrl:{other}")
        ob, og = _leafwise_bufs(tr, st)
        for path in rb:
            assert torch.equal(rb[path], ob[path]), (other, path)
            assert torch.equal(rg[path], og[path]), (other, path)


def test_dyadic_trajectory_bitexact_against_reference():
    """Before the first jump every step is exact arithmetic, so the port's
    resident Trainer and the reference's agree bit for bit: params,
    moments, snapshot buffers and Grams after 5 steps (jump at 5)."""
    from repro.configs import get_config
    batches = _int_batches(8)
    topt = OptimizerConfig(name="momentum", lr=0.5, b1=0.5)
    tr, st = _dot_fit(_dot_acfg(topt), batches, 5)
    jacfg = dataclasses.replace(
        get_config("pollutant-mlp"),
        dmd=JCfg(m=4, s=8, tol=1e-6, warmup_steps=2, cooldown_steps=0),
        optimizer=JOpt(name="momentum", lr=0.5, b1=0.5),
        parallel=JPar(grad_accum=1), train=JTrain(global_batch=8, seq_len=1))

    class JDot:
        def init(self, key):
            rng = np.random.default_rng(0)
            return {k: jnp.asarray(rng.integers(-4, 5, size=s), jnp.float32)
                    for k, s in LEAVES.items()}

        def loss(self, params, batch):
            return sum(jnp.vdot(params[k], batch[k]) for k in LEAVES), None

        def param_stack_dims(self):
            return STACK
    jtr = JTrainer(JDot(), jacfg)
    jst = jtr.fit(iter([{k: jnp.asarray(v) for k, v in b.items()}
                        for b in batches]), 5)
    jst = jtr.acc.state_leafwise(jst)
    for k in LEAVES:
        np.testing.assert_array_equal(st.params[k].numpy(),
                                      np.asarray(jst.params[k]), k)
        np.testing.assert_array_equal(st.opt_state[k].numpy(),
                                      np.asarray(jst.opt_state[k]), k)
    tb, tg = _leafwise_bufs(tr, st)
    for k in LEAVES:
        np.testing.assert_array_equal(tb["/" + k].numpy(),
                                      np.asarray(jst.dmd_buffers[k]), k)
        np.testing.assert_array_equal(tg["/" + k].numpy(),
                                      np.asarray(jst.dmd_gram[k]), k)


def test_tree_resident_leafwise_roundtrip():
    """The packed flat buffers equal the reference's tree_resident output
    bit for bit (same layout), pad lanes are zero, packed paths are None
    in the leaf subtree, and tree_leafwise gives back the leaves as views
    of the flat buffer."""
    rng = np.random.default_rng(3)
    np_params = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in LEAVES.items()}
    cfg_kw = dict(m=4, s=8, warmup_steps=0, cooldown_steps=0)
    jacc = JAcc(JCfg(**cfg_kw), stack_dims=STACK)
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    jres = jarena.tree_resident(jacc.arena_for(jparams), jparams)
    tacc = DMDAccelerator(DMDConfig(**cfg_kw), stack_dims=T_STACK,
                          device="cpu")
    params = {k: torch.tensor(v) for k, v in np_params.items()}
    table = tacc.arena_for(params)
    res = tarena.tree_resident(table, params)
    arenas, leaf = tarena.split_state(res)
    assert all(v is None for v in leaf.values())
    jarenas = jarena.split_state(jres)[0]
    assert sorted(arenas) == sorted(jarenas)
    for key, buf in arenas.items():
        np.testing.assert_array_equal(buf.numpy(), np.asarray(jarenas[key]))
        live = np.zeros(buf.numel(), bool)
        for seg in table[key].segments:
            for s in range(seg.n_sys):
                lo = seg.lane_start + s * seg.seg_lanes
                live[lo:lo + seg.flat_local] = True
        assert not buf.numpy()[~live].any()
    back = tarena.tree_leafwise(table, res)
    for k in LEAVES:
        assert torch.equal(back[k], params[k])
        flat = arenas[table[next(iter(table))].key]
        assert back[k].untyped_storage().data_ptr() == \
            flat.untyped_storage().data_ptr()


def test_staggered_moment_reset_masks_bucket_ranges():
    """Two staggered groups with adam: when the default group jumps at
    step 5 the 'vecs' group (phase 2) is mid-window. The resident masked
    reset (per bucket) must equal the pack-copy route's per-leaf masked
    reset bit for bit, zero the jumped group's moments and keep the
    other's."""
    groups = (DMDGroupRule(name="vecs", path_regex="/b|/v", phase=2),)
    batches = _float_batches(8)
    opt = OptimizerConfig(name="adam", lr=1e-2)
    tr_r, st_r = _dot_fit(_dot_acfg(opt, native=True, groups=groups),
                          batches, 6)
    tr_p, st_p = _dot_fit(_dot_acfg(opt, native=False, groups=groups),
                          batches, 6)
    assert tr_r.acc.n_groups == 2
    assert tr_r.acc.apply_groups(5) == (0,)
    _assert_equal(st_r.opt_state, st_p.opt_state, "moments")
    _assert_equal(st_r.params, st_p.params, "params")
    for k in ("w", "stack"):
        assert not st_r.opt_state.m[k].any(), k
    for k in ("b", "v"):
        assert st_r.opt_state.m[k].abs().max() > 0, k


# -- the differentiable combines (K2, K5) --------------------------------------

def _arena_case(dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    block_sys = [0, 0, 1, 2, 2, 2]
    seg = ka.Segments.from_block_sys(block_sys, 3, "cpu")
    x = torch.randn((6, 5, 128), generator=g, dtype=torch.float64).to(dtype)
    c = torch.randn((3, 5), generator=g, dtype=torch.float64)
    return x, c, seg, block_sys


def test_arena_combine_gradcheck():
    """K2's autograd twin in float64: its backward (K1's twin with the
    cotangent as the query) passes gradcheck, and the buffer takes no
    gradient."""
    x, c, seg, _ = _arena_case()
    c.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda cc: ka.combine(x, cc, seg), (c,))
    out = ka.combine(x, c, seg)
    assert out.requires_grad and not x.requires_grad


def test_flat_combine_gradcheck():
    g = torch.Generator().manual_seed(1)
    x = torch.randn((5, 3, 40), generator=g, dtype=torch.float64)
    c = torch.randn((3, 5), generator=g, dtype=torch.float64,
                    requires_grad=True)
    assert torch.autograd.gradcheck(lambda cc: kc.combine(x, cc), (c,))


def test_combine_grads_match_jax_grad_of_reference_twins():
    """fp32: the c-gradient of <w, r> through the port's combines equals
    jax.grad of the reference's combine_ref (arena and per leaf) on the
    same inputs (rtol 1e-5: fp32 sums over the lanes in two orders)."""
    x, c, seg, block_sys = _arena_case(torch.float32)
    c = c.float()
    r = torch.randn((6 * 128,), generator=torch.Generator().manual_seed(4))
    ct = c.clone().requires_grad_(True)
    (gt,) = torch.autograd.grad((ka.combine(x, ct, seg) * r).sum(), ct)

    def jloss(cj):
        w = jka.combine_ref(jnp.asarray(x.numpy()), cj,
                            jnp.asarray(block_sys, jnp.int32), block_n=128)
        return jnp.sum(w.reshape(-1) * jnp.asarray(r.numpy()))
    gj = jax.grad(jloss)(jnp.asarray(c.numpy()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                               atol=1e-5)

    xf = torch.randn((5, 2, 300), generator=torch.Generator().manual_seed(6))
    cf = torch.randn((2, 5), generator=torch.Generator().manual_seed(7))
    rf = torch.randn((2, 300), generator=torch.Generator().manual_seed(8))
    cft = cf.clone().requires_grad_(True)
    (gft,) = torch.autograd.grad((kc.combine(xf, cft) * rf).sum(), cft)
    for s in range(2):
        def jl(cj, s=s):
            w = jkref.combine_ref(jnp.asarray(xf[:, s].numpy()), cj)
            return jnp.sum(w * jnp.asarray(rf[s].numpy()))
        gjs = jax.grad(jl)(jnp.asarray(cf[s].numpy()))
        np.testing.assert_allclose(gft[s].numpy(), np.asarray(gjs),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["matpow", "eig"])
def test_dyadic_trajectory_bitexact_at_bucket_scope(mode):
    """Bucket scope on the dyadic trajectory: before the first jump the
    port's resident Trainer equals the reference's bit for bit (params,
    moments, buffers, the carried (1, m, m) bucket Gram, and the leaf-wise
    state K3 rebuilds for a checkpoint); the bucket Gram is the sum of the
    leaf-scope run's per-system Grams, exactly."""
    from repro.configs import get_config
    batches = _int_batches(8)
    topt = OptimizerConfig(name="momentum", lr=0.5, b1=0.5)
    acfg = _dot_acfg(topt)
    acfg = dataclasses.replace(acfg, dmd=dataclasses.replace(
        acfg.dmd, scope="bucket", mode=mode))
    tr, st = _dot_fit(acfg, batches, 5)
    tr_l, st_l = _dot_fit(_dot_acfg(topt), batches, 5)
    jacfg = dataclasses.replace(
        get_config("pollutant-mlp"),
        dmd=JCfg(m=4, s=8, tol=1e-6, warmup_steps=2, cooldown_steps=0,
                 scope="bucket", mode=mode),
        optimizer=JOpt(name="momentum", lr=0.5, b1=0.5),
        parallel=JPar(grad_accum=1), train=JTrain(global_batch=8, seq_len=1))

    class JDot:
        def init(self, key):
            rng = np.random.default_rng(0)
            return {k: jnp.asarray(rng.integers(-4, 5, size=s), jnp.float32)
                    for k, s in LEAVES.items()}

        def loss(self, params, batch):
            return sum(jnp.vdot(params[k], batch[k]) for k in LEAVES), None

        def param_stack_dims(self):
            return STACK
    jtr = JTrainer(JDot(), jacfg)
    jst = jtr.fit(iter([{k: jnp.asarray(v) for k, v in b.items()}
                        for b in batches]), 5)
    for key, g in st.dmd_gram["__arena__"].items():
        assert g.shape == (1, 4, 4), key
        np.testing.assert_array_equal(
            g.numpy(), np.asarray(jst.dmd_gram["__arena__"][key]), key)
        np.testing.assert_array_equal(
            g.numpy(), st_l.dmd_gram["__arena__"][key].numpy().sum(
                0, keepdims=True), key)
    lw, jlw = tr.acc.state_leafwise(st), jtr.acc.state_leafwise(jst)
    for k in LEAVES:
        for name in ("params", "opt_state", "dmd_buffers", "dmd_gram"):
            np.testing.assert_array_equal(
                getattr(lw, name)[k].numpy(),
                np.asarray(getattr(jlw, name)[k]), f"{name} {k}")
