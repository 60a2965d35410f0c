"""The port's jump controller (``core/controller.py``) and the schedule's
in-step math (``core/schedule.py``) against the reference's, on the cases
of tests/test_controller.py and tests/test_schedule.py: the same call
sequences through both packages, every state field compared after each
call.

Tolerance: exact. Every field is the same fp32/int32 arithmetic on the
same values in both packages (the EMA weights are rounded to fp32 the way
the reference rounds them), so counters, horizons, relax and ridge agree
bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs.base import DMDConfig as JCfg
from repro.configs.base import DMDControllerConfig as JCtrl
from repro.core import controller as JC
from repro.core import schedule as jsched
from repro.core.schedule import DMDGroupRule as JRule
from repro_torch.configs.base import DMDConfig, DMDControllerConfig
from repro_torch.core import controller as C
from repro_torch.core import schedule as sched
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.schedule import DMDGroupRule


def _groups(ridge=None, rule_ridge=None, **ctrl_kw):
    """Both packages' group tables for the reference tests' configs: the
    default group (m 6, s 20) and a staggered 'small' rule (m 4, s 8,
    phase 3)."""
    out = []
    for Cfg, Ctrl, Rule in ((JCfg, JCtrl, JRule),
                            (DMDConfig, DMDControllerConfig, DMDGroupRule)):
        ckw = dict(ctrl_kw)
        if ridge is not None:
            ckw.update(enabled=True, ridge=ridge)
        rkw = {} if rule_ridge is None else {"ridge": rule_ridge}
        cfg = Cfg(m=6, s=20, warmup_steps=0, cooldown_steps=0,
                  controller=Ctrl(**ckw),
                  groups=(Rule(name="small", max_ndim=1, m=4, s=8, phase=3,
                               **rkw),))
        mod = jsched if Cfg is JCfg else sched
        out.append(mod.resolve_groups(cfg))
    return out


def _same(js, ts):
    for name, a, b in zip(JC.ControllerState._fields, js, ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert str(b.dtype).removeprefix("torch.") == str(np.asarray(a).dtype)


def test_init_state_matches_reference():
    for kw in ({}, dict(ridge=0.02, rule_ridge=0.07)):
        jg, tg = _groups(**kw)
        _same(JC.init_state(jg), C.init_state(tg))
    jg, tg = _groups(ridge=0.02, rule_ridge=0.07)
    np.testing.assert_allclose(C.init_state(tg).ridge_eff.numpy(),
                               [0.02, 0.07], rtol=1e-7)


@pytest.mark.parametrize("pre,cand,tol", [
    (1.0, 0.99, 0.0), (1.0, 1.01, 0.0), (1.0, 1.01, 0.02),
    (1.0, np.nan, 0.0), (1.0, np.inf, 0.0), (1.0, 1e-9, -1.0),
    (0.5, 0.5005, 1e-3), (0.5, 0.50051, 1e-3)])
def test_gate_outcome_matches_reference(pre, cand, tol):
    want = bool(JC.gate_outcome(jnp.float32(pre), jnp.float32(cand), tol))
    got = C.gate_outcome(torch.tensor(pre, dtype=torch.float32),
                         torch.tensor(cand, dtype=torch.float32), tol)
    assert got.dtype == torch.bool and bool(got) == want


# (outcome, gain, level, jumped) sequences of tests/test_controller.py
SEQUENCES = {
    "accept_reject_scaled": [
        (JC.REJECT, 0.0, 0.5, (0,)), (JC.ACCEPT, 0.1, 0.5, (0,)),
        (JC.ACCEPT, 0.1, 0.5, (0,))] + [(JC.ACCEPT, 0.1, 0.5, (0,))] * 6 + [
        (JC.SCALED, 0.02, 0.5, (0,)), (JC.SCALED, 0.0, 0.5, (0,)),
        (JC.SCALED, 0.0, 0.5, (0,)), (JC.ACCEPT, 0.1, 0.5, (0,))],
    "shrink_floor": [(JC.REJECT, 0.0, 0.5, (0,))] * 10,
    "gain_ema": [(JC.ACCEPT, 0.5, 0.5, (0,)), (JC.ACCEPT, 0.5, 0.5, (0,))],
    "levels": [(JC.SCALED, 0.0, 0.25, (0,)), (JC.SCALED, 0.0, 0.25, (0,)),
               (JC.SCALED, 0.3, 0.5, (1,)), (JC.ACCEPT, -0.2, 0.5, (0, 1)),
               (JC.REJECT, 0.7, 0.5, (0, 1)), (JC.ACCEPT, 0.01, 0.5, (1,))],
}
CCFGS = [dict(grow=1.5, shrink=0.5, s_min=2.0, relax_floor=0.25,
              gain_ema=0.5),
         dict(gain_ema=0.8), dict(relax_floor=0.1, s_min=1.0)]


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
@pytest.mark.parametrize("ck", range(len(CCFGS)))
def test_update_on_jump_matches_reference(seq, ck):
    jg, tg = _groups()
    jc, tc = JCtrl(enabled=True, **CCFGS[ck]), \
        DMDControllerConfig(enabled=True, **CCFGS[ck])
    js, ts = JC.init_state(jg), C.init_state(tg)
    for outcome, gain, level, jumped in SEQUENCES[seq]:
        js = JC.update_on_jump(js, jumped, jnp.int32(outcome),
                               jnp.float32(gain), jc, jg,
                               level=jnp.float32(level))
        ts = C.update_on_jump(ts, jumped, outcome, torch.tensor(gain), tc,
                              tg, level=level)
        _same(js, ts)


@pytest.mark.parametrize("s_eff", [[7.6, 0.3], [20.0, 8.0], [25.0, 9.5],
                                   [1.49, 2.5], [0.0, 3.5]])
@pytest.mark.parametrize("s_min", [1.0, 2.0, 30.0])
def test_effective_s_matches_reference(s_eff, s_min):
    jg, tg = _groups()
    jc, tc = JCtrl(enabled=True, s_min=s_min), \
        DMDControllerConfig(enabled=True, s_min=s_min)
    js = JC.init_state(jg)._replace(s_eff=jnp.asarray(s_eff, jnp.float32))
    ts = C.init_state(tg)._replace(s_eff=torch.tensor(s_eff))
    want = np.asarray(JC.effective_s(js, jg, jc))
    got = C.effective_s(ts, tg, tc)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        sched.effective_s_array(tg, s_eff, s_floor=s_min), want)
    lo_j, caps_j = jsched.s_bounds(jg, s_floor=s_min)
    lo_t, caps_t = sched.s_bounds(tg, s_floor=s_min)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(caps_t.numpy(), np.asarray(caps_j))


@pytest.mark.parametrize("g_relax,g_ridge,jumped", [
    ([1.0, 1.0], [1.0, 1.0], (0,)), ([-1.0, -1.0], [-1.0, -1.0], (0,)),
    ([np.nan, -1.0], [-1.0, np.inf], (0, 1)), ([0.0, 0.0], [0.0, 0.0], (1,)),
    ([3e-7, -2.0], [-5e-9, 4.0], (0, 1))])
@pytest.mark.parametrize("meta_lr", [0.5, 1.0, 0.05])
def test_meta_update_matches_reference(g_relax, g_ridge, jumped, meta_lr):
    kw = dict(meta_lr=meta_lr, ridge_max=0.1, relax_floor=0.25)
    jg, tg = _groups(ridge=0.02, **kw)
    jc = JCtrl(enabled=True, ridge=0.02, **kw)
    tc = DMDControllerConfig(enabled=True, ridge=0.02, **kw)
    for start in ([0.02, 0.02], [5.0, 5.0]):
        js = JC.init_state(jg)._replace(
            relax_eff=jnp.asarray([0.8, 0.8], jnp.float32),
            ridge_eff=jnp.asarray(start, jnp.float32))
        ts = C.init_state(tg)._replace(relax_eff=torch.tensor([0.8, 0.8]),
                                       ridge_eff=torch.tensor(start))
        js = JC.meta_update(js, jumped, jnp.asarray(g_relax, jnp.float32),
                            jnp.asarray(g_ridge, jnp.float32), jc, jg)
        ts = C.meta_update(ts, jumped, torch.tensor(g_relax),
                           torch.tensor(g_ridge), tc, tg)
        _same(js, ts)


def test_meta_update_sign_directions():
    """The reference test's numbers: relax toward the floor / 1, ridge
    toward 0 / ridge_max, the other group untouched."""
    _, tg = _groups(ridge=0.02, meta_lr=0.5, ridge_max=0.1,
                    relax_floor=0.25)
    tc = DMDControllerConfig(enabled=True, meta_lr=0.5, ridge_max=0.1,
                             relax_floor=0.25, ridge=0.02)
    st = C.init_state(tg)._replace(relax_eff=torch.tensor([0.8, 0.8]),
                                   ridge_eff=torch.tensor([0.02, 0.02]))
    up = C.meta_update(st, (0,), torch.ones(2), torch.ones(2), tc, tg)
    assert float(up.relax_eff[0]) == pytest.approx(0.525)
    assert float(up.ridge_eff[0]) == pytest.approx(0.01)
    dn = C.meta_update(st, (0,), -torch.ones(2), -torch.ones(2), tc, tg)
    assert float(dn.relax_eff[0]) == pytest.approx(0.9)
    assert float(dn.ridge_eff[0]) == pytest.approx(0.06)
    for out in (up, dn):
        assert float(out.relax_eff[1]) == pytest.approx(0.8)
        assert float(out.ridge_eff[1]) == pytest.approx(0.02)


def test_summary_matches_reference():
    jg, tg = _groups(ridge=0.02, rule_ridge=0.07)
    js, ts = JC.init_state(jg), C.init_state(tg)
    js = JC.update_on_jump(js, (1,), jnp.int32(JC.SCALED), jnp.float32(0.3),
                           JCtrl(enabled=True), jg, level=jnp.float32(0.25))
    ts = C.update_on_jump(ts, (1,), C.SCALED, 0.3,
                          DMDControllerConfig(enabled=True), tg, level=0.25)
    assert C.summary(ts, tg) == JC.summary(js, jg)
    assert "ridge_eff" in C.summary(ts, tg) and "0.0700" in C.summary(ts, tg)


def test_accelerator_controller_integration():
    acc = DMDAccelerator(DMDConfig(m=6, s=20, warmup_steps=0,
                                   cooldown_steps=0), device="cpu")
    assert not acc.controller_on and acc.init_controller() is None
    acc_on = DMDAccelerator(DMDConfig(
        m=6, s=20, warmup_steps=0, cooldown_steps=0,
        controller=DMDControllerConfig(enabled=True)), device="cpu")
    assert acc_on.controller_on
    st = acc_on.init_controller()
    assert isinstance(st, C.ControllerState)
    assert st.s_eff.shape == (acc_on.n_groups,)
    assert acc_on.arena_on and not DMDAccelerator(
        DMDConfig(arena=False), device="cpu").arena_on


# -- the schedule's in-step math ----------------------------------------------

def _sched_groups():
    jrules = (JRule(name="vecs", max_ndim=1, m=5, phase=2, cooldown_steps=3),
              JRule(name="late", path_regex="l2", m=4, warmup_steps=9,
                    phase=1))
    trules = (DMDGroupRule(name="vecs", max_ndim=1, m=5, phase=2,
                           cooldown_steps=3),
              DMDGroupRule(name="late", path_regex="l2", m=4, warmup_steps=9,
                           phase=1))
    kw = dict(m=6, s=12, warmup_steps=4, cooldown_steps=2)
    return (jsched.resolve_groups(JCfg(groups=jrules, **kw)),
            sched.resolve_groups(DMDConfig(groups=trules, **kw)))


def test_slots_for_step_matches_reference_and_host():
    jg, tg = _sched_groups()
    for step in range(0, 80):
        want = np.asarray(jsched.slots_for_step(jg, jnp.int32(step)))
        got = sched.slots_for_step(tg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(sched.slots_array(tg, step), want)


def test_schedule_records_and_collisions_match_reference():
    jg, tg = _sched_groups()
    assert sched.schedule_records(tg) == jsched.schedule_records(jg)
    assert sched.jump_collisions(tg) == jsched.jump_collisions(jg)
    assert np.array_equal(sched.s_caps(tg), jsched.s_caps(jg))
