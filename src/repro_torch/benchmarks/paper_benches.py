"""One benchmark per paper figure or claim, the reference's
``benchmarks/paper_benches.py`` suites on the port, with the reference's
rows (CSV strings, same headers, labels and columns):

  fig3_sensitivity   (m, s) grid of the mean relative improvement per jump
  fig4_curves        train/test MSE curves: baseline, DMD and the gated
                     controller at equal step count
  controller         the loss-gated controller against the fixed schedule:
                     outcomes, loss against wall, the gate's jump overhead
  sec3_overhead      DMD arithmetic against backprop: the analytic op
                     counts, one Adam step and one recompute jump measured
  streaming_gram     record and apply on one (n,) leaf: streaming Gram (K4
                     per record, K5 per jump) against recompute (K6 + K5)
  staggered_jump     synchronous against staggered per-group jumps: the
                     per-step spike, concurrency, snapshot bytes

Every suite takes ``device`` (default "cuda", which raises without a
card; the tests pass "cpu", where the kernels' twins run). Walls are
host-clock seconds (``time.perf_counter``) around work that ends in
``torch.cuda.synchronize``. The init is the port's (a seeded torch
generator, not ``jax.random``), so measured values differ from the
reference's committed ``BENCH_*.json``; schedule-determined and analytic
rows do not: ``schema_errors``, ``fixed_fields`` and ``measured_values``
say what two runs of a suite at the same arguments share.
"""
from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs.base import (ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      TrainConfig)
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.core import leafplan
from repro_torch.core import snapshots as snap
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.core.schedule import DMDGroupRule
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.kernels.device import resolve_device
from repro_torch.models.mlp_net import MLPModel, init_mlp, mse_loss
from repro_torch.optim.optimizers import apply_updates, make_optimizer
from repro_torch.train import Trainer, make_dmd_step, paper_loop

# fig4's gated run: the validation-gated controller with the shrink ladder
# and meta-tuning (the reference's ``_train_gated``)
GATED_CTRL = dict(enabled=True, eval_rows=0, val_gate=True,
                  shrink_levels=(0.5, 0.25), meta_lr=0.05)
CURVE_EVERY = 50                 # fig3/fig4's steps between two samples


def _now(dev: torch.device) -> float:
    """The host clock once the device's queued work has finished."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _put(dev: torch.device, *arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in arrays)


def _acfg(dmd: DMDConfig, rows: int) -> ArchConfig:
    """The Trainer config of the reference suites: the MLP, Adam 1e-3, one
    full batch of `rows` per step."""
    return ArchConfig(
        model=ModelConfig(name="pollutant-mlp", family="mlp"), dmd=dmd,
        optimizer=OptimizerConfig(name="adam", lr=paper_loop.LR),
        parallel=ParallelConfig(grad_accum=1),
        train=TrainConfig(global_batch=int(rows), seq_len=1), shapes=())


def _train(dmd_cfg, sizes, X, Y, Xte, Yte, steps, *, params=None,
           device="cuda"):
    """The fig3/fig4 loop (the reference's ``_train``): Adam at lr 1e-3, no
    guard, every jump's moments reset, no carried Gram, so every jump
    recomputes it (K3 and K2 on the arena route). One schedule group, as
    the reference's scalar ``acc.slot(t)`` requires: then
    ``paper_loop.train``'s slot vector, per-group relax and group-masked
    moment reset are the reference's scalar slot, ``round_index`` relax
    and ``opt.init``. `params` (the reference's layout) replaces the
    seeded init. Returns ((t, train MSE, test MSE) every 50 steps and at
    the last, the per-jump loss ratios)."""
    res = paper_loop.train(X, Y, sizes,
                           dataclasses.replace(dmd_cfg, streaming_gram=False),
                           steps, params=params, test=(Xte, Yte),
                           log_every=CURVE_EVERY, guard=False, device=device)
    return res.curve, res.jumps


def fig3_sensitivity(ms=(6, 10, 14), ss=(10, 30, 55), steps=450,
                     device="cuda") -> List[str]:
    """Paper Fig 3: the mean relative improvement per jump over an (m, s)
    grid, on the 600-row teacher at sizes (6, 40, 100, 400)."""
    X, Y = synthetic_regression()
    Xte, Yte = synthetic_regression(seed=7, n=150)
    sizes = (6, 40, 100, Y.shape[1])
    rows = ["fig3,m,s,mean_rel_improvement,n_jumps"]
    for m in ms:
        for s in ss:
            cfg = DMDConfig(m=m, s=s, tol=1e-4, warmup_steps=100,
                            cooldown_steps=10)
            _, jumps = _train(cfg, sizes, X, Y, Xte, Yte, steps,
                              device=device)
            mri = float(np.mean(jumps)) if jumps else float("nan")
            rows.append(f"fig3,{m},{s},{mri:.4f},{len(jumps)}")
    return rows


def _train_gated(sizes, X, Y, Xval, Yval, Xte, Yte, steps, m=14, s=55, *,
                 params=None, device="cuda"):
    """fig4's validation-gated controller run (the reference's
    ``_train_gated``): the Trainer on the same train rows and step count as
    ``_train``, jumps gated on the disjoint fold (Xval, Yval). ``fit`` runs
    in segments ending at the curve's sampling steps (13 calls over 600
    steps), each capturing its own CUDA graphs on the card. Returns
    (curve, {outcome: count}, the summed ``graph_stats`` of the fits)."""
    dev = resolve_device(device)
    dmd = DMDConfig(m=m, s=s, tol=1e-4, warmup_steps=100, cooldown_steps=10,
                    controller=DMDControllerConfig(**GATED_CTRL))
    trainer = Trainer(MLPModel(sizes), _acfg(dmd, len(X)), device=dev,
                      val_batch=dict(zip("xy", _put(dev, Xval, Yval))))
    X, Y, Xte, Yte = _put(dev, X, Y, Xte, Yte)
    outcomes = {0: 0, 1: 0, 2: 0}
    graphs = {}

    def on_m(t, metrics):
        if "ctrl_outcome" in metrics:
            outcomes[int(metrics["ctrl_outcome"])] += 1

    batch = {"x": X, "y": Y}
    batches = iter(lambda: batch, None)
    state, curve = trainer.init_state(params=params), []
    for t in range(steps):
        if t % CURVE_EVERY == 0 or t == steps - 1:
            state = trainer.fit(batches, t + 1, state=state, on_metrics=on_m)
            for k, v in trainer.graph_stats.items():
                graphs[k] = graphs.get(k, 0) + v
            with torch.no_grad():
                curve.append((t, float(mse_loss(state.params, X, Y)),
                              float(mse_loss(state.params, Xte, Yte))))
    return curve, outcomes, graphs


FIG4_DMD = dict(m=14, s=55, tol=1e-4, warmup_steps=100, cooldown_steps=10)


def fig4_split():
    """fig4's one teacher in every split: 600 train rows, a 150-row
    validation fold (the gate's) and 150 held-out test rows."""
    X, Y = synthetic_regression(n=900)
    return X[:600], Y[:600], X[600:750], Y[600:750], X[750:], Y[750:]


def fig4_runs(steps=600, device="cuda") -> dict:
    """fig4's three runs at equal step count on (6, 40, 200, 400): the
    baseline's curve, the paper's ungated DMD schedule (curve, jump
    ratios), and the validation-gated controller (curve, {outcome:
    count}, summed ``graph_stats``, wall seconds)."""
    dev = resolve_device(device)
    X, Y, Xval, Yval, Xte, Yte = fig4_split()
    sizes = (6, 40, 200, Y.shape[1])
    base, _ = _train(DMDConfig(enabled=False), sizes, X, Y, Xte, Yte, steps,
                     device=device)
    dmd = _train(DMDConfig(**FIG4_DMD), sizes, X, Y, Xte, Yte, steps,
                 device=device)
    t0 = _now(dev)
    gated = _train_gated(sizes, X, Y, Xval, Yval, Xte, Yte, steps,
                         device=device)
    return {"baseline": base, "dmd": dmd,
            "gated": gated + (_now(dev) - t0,)}


def fig4_rows(runs: dict) -> List[str]:
    """Paper Fig 4's rows from ``fig4_runs``: MSE against steps, train and
    test, per run; the final rows give signed deltas against the baseline
    with explicit WINS/LOSES tokens."""
    base, (dmd, _) = runs["baseline"], runs["dmd"]
    gated, outcomes = runs["gated"][:2]
    rows = ["fig4,step,baseline_train,baseline_test,dmd_train,dmd_test,"
            "gated_train,gated_test"]
    for (t, btr, bte), (_, dtr, dte), (_, gtr, gte) in zip(base, dmd, gated):
        rows.append(f"fig4,{t},{btr:.5e},{bte:.5e},{dtr:.5e},{dte:.5e},"
                    f"{gtr:.5e},{gte:.5e}")

    def final_rows(name, run):
        out = []
        for split, idx in (("train", 1), ("test", 2)):
            b, v = base[-1][idx], run[-1][idx]
            delta = (v - b) / max(b, 1e-30)
            verdict = "WINS" if v <= b else "LOSES"
            out.append(f"fig4_final,{split},{name},{v:.5e},baseline,"
                       f"{b:.5e},delta,{delta:+.1%},{name}_{verdict}")
        return out

    rows += final_rows("dmd", dmd) + final_rows("gated", gated)
    rows.append(f"fig4_final_ratio,train,"
                f"{base[-1][1] / max(dmd[-1][1], 1e-30):.2f}x,gated_train,"
                f"{base[-1][1] / max(gated[-1][1], 1e-30):.2f}x")
    rows.append(f"fig4_gate_outcomes,accepts,{outcomes[2]},scaled,"
                f"{outcomes[1]},rejects,{outcomes[0]}")
    return rows


def fig4_curves(steps=600, device="cuda") -> List[str]:
    """Paper Fig 4: ``fig4_rows`` of ``fig4_runs``."""
    return fig4_rows(fig4_runs(steps, device))


def controller(steps=450, sizes=(6, 40, 100, 400), m=14, s=55,
               log_every=25, device="cuda") -> List[str]:
    """The loss-gated controller against the fixed schedule on the MLP at
    equal step count: final train MSE, accept/scale/reject counts, the
    unrecovered rejects (a rollback leak: the train loss after a rejected
    jump above the pre-jump eval loss by 10%; must be 0), the adapted
    knobs, (step, wall, loss) curves of both runs and the per-gate rows,
    and the gated jump step's wall against the ungated one on the same
    state. Both jump steps run eagerly (the Trainer never captures a
    jump), each call rethreading the state it returned."""
    dev = resolve_device(device)
    # one teacher, split into train and held-out rows: the gate scores
    # jumps on unseen samples of the same task
    Xall, Yall = synthetic_regression(n=750, n_out=sizes[-1])
    X, Y = _put(dev, Xall[:600], Yall[:600])
    batch = {"x": X, "y": Y}
    eval_batch = dict(zip("xy", _put(dev, Xall[600:], Yall[600:])))

    def acfg_for(ctrl_on):
        return _acfg(DMDConfig(
            m=m, s=s, tol=1e-4, warmup_steps=100, cooldown_steps=10,
            controller=DMDControllerConfig(enabled=ctrl_on, eval_rows=0)),
            len(X))

    def run(ctrl_on):
        trainer = Trainer(MLPModel(sizes), acfg_for(ctrl_on), device=dev)
        outcomes, curve = [], []
        t0 = _now(dev)

        def on_m(t, metrics):
            if "ctrl_outcome" in metrics:
                outcomes.append((t, int(metrics["ctrl_outcome"]),
                                 float(metrics["ctrl_loss_pre"]),
                                 float(metrics["ctrl_loss_jump"]),
                                 float(metrics["ctrl_loss_kept"])))
            if t % log_every == 0 or t == steps - 1:
                loss = float(metrics["loss"])
                curve.append((t, time.perf_counter() - t0, loss))

        state = trainer.fit(iter(lambda: batch, None), steps,
                            on_metrics=on_m, eval_batch=eval_batch)
        final = float(mse_loss(state.params, X, Y))
        return trainer, state, final, outcomes, curve

    tr_fix, st_fix, loss_fix, _, curve_fix = run(False)
    tr_ctl, st_ctl, loss_ctl, outcomes, curve_ctl = run(True)

    ctrl = st_ctl.controller
    n_acc = int(ctrl.accepts.sum())
    n_scl = int(ctrl.scaled.sum())
    n_rej = int(ctrl.rejects.sum())
    unrecovered = 0
    for (t, o, pre, jump, kept) in outcomes:
        if o != 0:
            continue
        after = [l for (ts, _, l) in curve_ctl if ts > t]
        if after and after[0] > pre * 1.10:
            unrecovered += 1

    jump_step = next(t for t in range(steps)
                     if tr_ctl.acc.apply_groups(t))
    relax = tr_ctl.acc.relax_vector(jump_step)
    groups = tr_ctl.acc.apply_groups(jump_step)
    gated = make_dmd_step(acfg_for(True), acc=tr_ctl.acc,
                          model=MLPModel(sizes), device=dev)
    plain = make_dmd_step(acfg_for(False), acc=tr_fix.acc, device=dev)

    def walls(fn, st, reps=7):
        st = fn(st)[0]                                # warm-up
        ts = []
        for _ in range(reps):
            t0 = _now(dev)
            st, _ = fn(st)
            ts.append(_now(dev) - t0)
        return float(np.median(ts)) * 1e3

    def clone(st):
        return map_with_paths(lambda _, x: x.clone(), st)

    t_gated = walls(lambda st: gated(st, relax, eval_batch, groups=groups),
                    clone(st_ctl))
    t_plain = walls(lambda st: plain(st, relax, groups=groups),
                    clone(st_fix))

    rows = [
        "controller,metric,fixed_schedule,controller,note",
        f"controller,final_train_mse,{loss_fix:.5e},{loss_ctl:.5e},"
        f"equal step count ({steps}); gated run "
        f"{'BEATS' if loss_ctl <= loss_fix else 'LOSES TO'} fixed "
        f"({loss_fix / max(loss_ctl, 1e-30):.2f}x)",
        f"controller,jump_outcomes,-,"
        f"accept={n_acc}/scaled={n_scl}/reject={n_rej},"
        f"{len(outcomes)} gated jumps",
        f"controller,unrecovered_rejects,-,{unrecovered},"
        f"post-reject train loss never exceeds pre-jump eval loss +10%",
        f"controller,s_eff_final,-,"
        + "/".join(f"{v:.1f}" for v in ctrl.s_eff.cpu().numpy())
        + f",adapted horizon (cap {s})",
        f"controller,relax_eff_final,-,"
        + "/".join(f"{v:.3f}" for v in ctrl.relax_eff.cpu().numpy())
        + ",effective relax scale",
        f"controller,jump_step_wall_ms,{t_plain:.2f},{t_gated:.2f},"
        f"gate overhead {t_gated - t_plain:+.2f} ms on jump steps only "
        f"(2-3 eval forwards + one params-sized blend)",
    ]
    for (t, w, l) in curve_fix:
        rows.append(f"controller,curve_fixed,{t},{w:.2f},{l:.5e}")
    for (t, w, l) in curve_ctl:
        rows.append(f"controller,curve_gated,{t},{w:.2f},{l:.5e}")
    for (t, o, pre, jump, kept) in outcomes:
        rows.append(f"controller,gate,{t},"
                    f"{['reject', 'scaled', 'accept'][o]},"
                    f"pre={pre:.5e} jump={jump:.5e} kept={kept:.5e}")
    return rows


def sec3_overhead(m=14, t_samples=800, device="cuda") -> List[str]:
    """Paper §3: DMD ops ~ n(3m^2 + r^2) per round against backprop ~ 6nt
    per epoch, then one Adam step and one recompute jump (K3 + K2, no
    carried Gram) measured on the paper's MLP at full width."""
    dev = resolve_device(device)
    sizes = PAPER_SIZES
    params = init_mlp(torch.Generator().manual_seed(0), sizes, device=dev)
    n = sum(x.numel() for _, x in leaves_with_paths(params))
    r = m - 1
    dmd_ops = n * (3 * m ** 2 + r ** 2)
    bp_ops = 6 * n * t_samples
    rows = [f"sec3,analytic_dmd_ops_per_round,{dmd_ops:.3e}",
            f"sec3,analytic_backprop_ops_per_epoch,{bp_ops:.3e}",
            f"sec3,dmd_rounds_per_m_epochs_overhead,"
            f"{dmd_ops / (m * bp_ops):.4f}"]

    X, Y = _put(dev, np.random.default_rng(0).uniform(
        -1, 1, size=(t_samples, 6)), np.random.default_rng(1).normal(
        size=(t_samples, sizes[-1])))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-3))

    def step(p, s, t):
        _, g = paper_loop.value_and_grad(p, X, Y)
        with torch.no_grad():
            u, s = opt.update(g, s, p, t)
            return apply_updates(p, u), s

    acc = DMDAccelerator(DMDConfig(m=m, s=55, tol=1e-4), device=dev)
    bufs = acc.init(params)
    p, s = params, opt.init(params)
    for t in range(m):                               # warm + fill buffers
        p, s = step(p, s, t)
        bufs, _ = acc.record(bufs, p, t % m)

    reps = 10
    t0 = _now(dev)
    for t in range(reps):
        p, s = step(p, s, t)
    t_step = (_now(dev) - t0) / reps

    acc.apply(p, bufs, 0)                            # warm-up
    t0 = _now(dev)
    for _ in range(reps):
        acc.apply(p, bufs, 0)
    t_dmd = (_now(dev) - t0) / reps

    overhead = 1.0 + t_dmd / (m * t_step)
    rows += [f"sec3,measured_train_step_ms,{t_step*1e3:.2f}",
             f"sec3,measured_dmd_jump_ms,{t_dmd*1e3:.2f}",
             f"sec3,wall_overhead_factor,{overhead:.3f}",
             "sec3,paper_wall_overhead_factor,1.41 (host-copy bound); "
             "theoretical 1.07"]
    return rows


def _timeit(dev: torch.device, fn, reps=10) -> float:
    """Mean seconds of fn() over `reps` calls after one warm-up call."""
    fn()
    t0 = _now(dev)
    for _ in range(reps):
        fn()
    return (_now(dev) - t0) / reps


def streaming_gram(m=14, n=4_000_000, reps=10, device="cuda") -> List[str]:
    """Record and apply on one (n,) leaf, per-leaf route (``arena=False``):
    the streaming-Gram engine (one Gram row per record, K4; the jump's
    combine, K5) against the recompute path (plain records; the jump's
    full Gram, K6, and combine, K5), with the per-window FLOP and byte
    accounting of the O(m^2 n) -> O(m n) apply-side reduction. Records
    write one ring row in place; rewriting slot m - 1 with the same params
    leaves the buffer and the Gram as they were, so every timed call sees
    the same state (the reference copies because its calls donate)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    w0, = _put(dev, rng.normal(size=(n,)))
    params = {"w": w0}
    cfg = DMDConfig(m=m, s=55, tol=1e-4, anchor="first", warmup_steps=0,
                    cooldown_steps=0, streaming_gram=True, arena=False)
    acc_s = DMDAccelerator(cfg, device=dev)
    acc_r = DMDAccelerator(dataclasses.replace(cfg, streaming_gram=False),
                           device=dev)
    bufs = acc_s.init(params)
    grams = acc_s.init_grams(bufs)
    plans = acc_s.plans_for(params)

    def rec_stream(p, slot):
        snap.record(bufs, p, slot, plans)
        snap.update_grams(grams, bufs, slot, cfg, plans)

    for slot in range(m):                        # fill one window
        params = {"w": params["w"] + 0.01}
        rec_stream(params, slot)

    t_rec_plain = _timeit(dev, lambda: snap.record(bufs, params, m - 1,
                                                   plans), reps)
    t_rec_stream = _timeit(dev, lambda: rec_stream(params, m - 1), reps)
    # apply returns new params and leaves its inputs as they were: no copy
    t_apply_rec = _timeit(dev, lambda: acc_r.apply(params, bufs, 0), reps)
    t_apply_stream = _timeit(
        dev, lambda: acc_s.apply(params, bufs, 0, grams=grams), reps)

    f_gram, f_row, f_comb = 2 * m * m * n, 2 * m * n, 2 * m * n
    f_apply_rec = f_gram + f_comb
    f_apply_stream = f_comb + 2 * m ** 3
    b_buf = 4 * m * n
    return [
        "streaming,metric,recompute_seed,streaming,reduction",
        f"streaming,gram_flops_per_event,{f_gram:.3e},{f_row:.3e},"
        f"{f_gram / f_row:.1f}x (predicted m={m})",
        f"streaming,apply_flops,{f_apply_rec:.3e},{f_apply_stream:.3e},"
        f"{f_apply_rec / f_apply_stream:.1f}x (predicted ~(m+1)={m + 1}: "
        f"the combine pass is shared)",
        f"streaming,apply_buffer_bytes,{2 * b_buf:.3e},{b_buf:.3e},2.0x",
        f"streaming,apply_wall_ms,{t_apply_rec * 1e3:.2f},"
        f"{t_apply_stream * 1e3:.2f},{t_apply_rec / t_apply_stream:.1f}x "
        f"(the synchronous jump stall every m steps)",
        f"streaming,record_wall_ms,{t_rec_plain * 1e3:.2f},"
        f"{t_rec_stream * 1e3:.2f},"
        f"(streaming amortizes one O(m*n)={f_row:.1e}-FLOP row pass into "
        f"each train step, where it overlaps backprop — DESIGN.md 2.3)",
        f"streaming,m,{m},n,{n}",
    ]


def staggered_config(m: int) -> DMDConfig:
    """The staggered schedule: half the matrices on the default group (m,
    phase 0, jump residue m - 1 mod m), /l2/'s matrix on phase m // 2, the
    1-D leaves on m // 2 windows at phase 3, so the three groups' jump
    steps never coincide."""
    return DMDConfig(m=m, s=55, tol=1e-4, anchor="first", warmup_steps=0,
                     cooldown_steps=0, groups=(
                         DMDGroupRule(name="late_half", path_regex="/l2/",
                                      min_ndim=2, phase=m // 2),
                         DMDGroupRule(name="vectors", max_ndim=1,
                                      m=m // 2, phase=3)))


def staggered_fill(acc: DMDAccelerator) -> int:
    """Steps that fill every group's first window."""
    return max(g.warmup_steps + g.phase + g.cycle for g in acc.groups)


def staggered_jump(m=14, sizes=(6, 800, 800, 800), reps=10,
                   device="cuda") -> List[str]:
    """The per-group schedule's two wins over the synchronous jump: the
    largest single group's jump (the per-step spike) against the whole
    tree's, and the snapshot bytes the vector group's half-length window
    saves, plus a schedule audit over 4000 steps. Arena route with carried
    Grams: K1 per recording bucket and record, K2 per jumped bucket."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    cfg_sync = dataclasses.replace(staggered_config(m), groups=())
    cfg_stag = staggered_config(m)
    params = init_mlp(torch.Generator().manual_seed(0), sizes, device=dev)

    def setup(cfg):
        acc = DMDAccelerator(cfg, device=dev)
        bufs = acc.init(params)
        grams = acc.init_grams(bufs)
        p = params
        # fill every group's window with a drifting trajectory
        for t in range(staggered_fill(acc)):
            p = map_with_paths(lambda _, x: x + 0.01 * _put(
                dev, rng.normal(size=tuple(x.shape)))[0], p)
            if acc.should_record(t):
                bufs, grams = acc.record(bufs, p, acc.slots(t), grams)
        return acc, p, bufs, grams

    def time_jump(acc, p, bufs, grams, groups):
        """Median of per-call walls, each synchronised: the spike is a
        max-statistic, so the estimator must resist timing noise."""
        acc.apply(p, bufs, grams=grams, groups=groups)       # warm-up
        walls = []
        for _ in range(reps):
            t0 = _now(dev)
            acc.apply(p, bufs, grams=grams, groups=groups)
            walls.append(_now(dev) - t0)
        return float(np.median(walls)) * 1e3                 # ms

    def jump_flops(acc, groups):
        """Analytic per-jump cost: one combine pass 2*m*n + O(m^3) algebra
        per jumped leaf."""
        return sum(2 * pl.m * pl.flat_size
                   * int(np.prod(pl.shape[:pl.stack_dims]))
                   + 2 * pl.m ** 3
                   for pl in leafplan.plan_entries(acc.plans_for(params))
                   if pl.group in groups)

    acc_sync, p_s, bufs_s, grams_s = setup(cfg_sync)
    t_sync = time_jump(acc_sync, p_s, bufs_s, grams_s, (0,))
    f_sync = jump_flops(acc_sync, (0,))

    acc_stag, p_t, bufs_t, grams_t = setup(cfg_stag)
    per_group = [time_jump(acc_stag, p_t, bufs_t, grams_t, (g.index,))
                 for g in acc_stag.groups]
    t_stag_max = max(per_group)
    f_stag_max = max(jump_flops(acc_stag, (g.index,))
                     for g in acc_stag.groups)

    horizon = 4000
    conc = max(len(acc_stag.apply_groups(t)) for t in range(horizon))
    n_jump_steps_sync = sum(bool(acc_sync.apply_groups(t))
                            for t in range(horizon))
    n_jump_steps_stag = sum(bool(acc_stag.apply_groups(t))
                            for t in range(horizon))

    def buffer_bytes(acc):
        return sum(4 * pl.m * int(np.prod(pl.shape))
                   for pl in leafplan.plan_entries(acc.plans_for(params)))

    b_sync, b_stag = buffer_bytes(acc_sync), buffer_bytes(acc_stag)

    return [
        "staggered_jump,metric,synchronous,staggered,note",
        f"staggered_jump,max_step_jump_ms,{t_sync:.2f},{t_stag_max:.2f},"
        f"spike ratio {t_sync / max(t_stag_max, 1e-9):.2f}x (largest single "
        f"group vs whole tree; median of blocked calls)",
        f"staggered_jump,max_step_jump_flops,{f_sync:.3e},{f_stag_max:.3e},"
        f"analytic {f_sync / f_stag_max:.2f}x (combine + m^3 algebra per "
        f"jumped leaf — deterministic)",
        "staggered_jump,per_group_jump_ms,-,"
        + "/".join(f"{t:.2f}" for t in per_group)
        + "," + "/".join(g.name for g in acc_stag.groups),
        f"staggered_jump,max_groups_jumping_per_step,"
        f"{len(acc_sync.groups) and 'all-leaves'},{conc},"
        f"phase residues disjoint over {horizon} steps",
        f"staggered_jump,jump_steps_per_{horizon},{n_jump_steps_sync},"
        f"{n_jump_steps_stag},staggered pays MORE often but each spike is "
        f"smaller (amortized)",
        f"staggered_jump,snapshot_buffer_bytes,{b_sync},{b_stag},"
        f"{b_sync - b_stag} bytes saved by halving the vector group's "
        f"window ({(1 - b_stag / b_sync) * 100:.2f}% of this MLP's total)",
        f"staggered_jump,m,{m},sizes,{'x'.join(map(str, sizes))}",
    ]


# -- comparing two runs of a suite --------------------------------------------

_NUMBER = r"[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|inf|nan)"
_VERDICT = re.compile(r"WINS|LOSES|BEATS|accept|scaled|reject")


def numbers(field: str) -> List[float]:
    return [float(x) for x in re.findall(_NUMBER, field)]


def schema_errors(rows: List[str], ref_rows: List[str]) -> List[str]:
    """Where `rows` leave the schema of `ref_rows` (the same suite at the
    same arguments, e.g. the reference's): the row count, the header, each
    row's field count and first field, and, field by field, the words
    around the numbers (a field holding a verdict aside); every number
    must be finite."""
    errs = []
    if len(rows) != len(ref_rows) or not rows:
        return [f"{len(rows)} rows, the reference {len(ref_rows)}"]
    if rows[0] != ref_rows[0]:
        errs.append(f"header {rows[0]!r}, the reference {ref_rows[0]!r}")
    for row, ref in zip(rows, ref_rows):
        f, rf = row.split(","), ref.split(",")
        if len(f) != len(rf) or f[0] != rf[0]:
            errs.append(f"{row!r} against the reference's {ref!r}")
            continue
        for a, b in zip(f, rf):
            if a != b and not _VERDICT.search(b) and \
                    re.sub(_NUMBER, "#", a) != re.sub(_NUMBER, "#", b):
                errs.append(f"field {a!r} against the reference's {b!r}")
        if not all(math.isfinite(v) for a in f for v in numbers(a)):
            errs.append(f"a number that is not finite in {row!r}")
    return errs


def fixed_fields(suite: str, rows: List[str]) -> list:
    """The fields of a suite's rows that its schedule or its arithmetic
    alone determines, equal in every run at the same arguments whatever
    the init and the device: fig3's (m, s, jump count), fig4's steps,
    labels and gate-outcome total, the controller's labels, sampled steps
    and gated jump steps, sec3's op counts, streaming_gram's FLOP and byte
    rows, staggered_jump's FLOPs, concurrency, jump steps and buffer
    bytes. `suite` is the ``BENCH_<suite>.json`` name."""
    f = [r.split(",") for r in rows]
    if suite == "fig3":
        return [x[:3] + x[4:] for x in f]                 # all but the mean
    if suite == "fig4":
        (g,) = [x for x in f if x[0] == "fig4_gate_outcomes"]
        return ([x[:2] for x in f if x[0] == "fig4"]
                + [x[:3] + x[4:5] + x[6:7] for x in f
                   if x[0] == "fig4_final"]
                + [g[:2] + g[3::2], [sum(int(v) for v in g[2::2])]])
    if suite == "controller":
        keyed = ("curve_fixed", "curve_gated", "gate")
        return ([x[:3] if x[1] in keyed else x[:2] for x in f]
                + [x[-1:] for x in f if x[1] == "jump_outcomes"]
                + [x for x in f if x[1] == "unrecovered_rejects"])
    if suite == "sec3_overhead":
        return f[:3] + f[6:] + [x[:2] for x in f[3:6]]
    if suite == "streaming_gram":
        return f[:4] + f[6:] + [f[4][:2], f[5][:2] + f[5][4:]]
    if suite == "staggered_jump":
        return [f[i] for i in (0, 2, 4, 5, 6, 7)] + [f[1][:2],
                                                     f[3][:3] + f[3][4:]]
    raise KeyError(suite)


def measured_values(suite: str, rows: List[str]) -> List[float]:
    """The measured numbers of a suite's rows (MSEs, means, walls), which
    must be positive."""
    f = [r.split(",") for r in rows]
    if suite == "fig3":
        return [float(x[3]) for x in f[1:]]
    if suite == "fig4":
        return [float(v) for x in f if x[0] == "fig4" and x[1] != "step"
                for v in x[2:]]
    if suite == "controller":
        return ([float(v) for v in f[1][2:4]] + [float(x[4]) for x in f
                 if x[1] in ("curve_fixed", "curve_gated")]
                + [float(v) for v in f[6][2:4]])
    if suite == "sec3_overhead":
        return [float(x[2]) for x in f[3:6]]
    if suite == "streaming_gram":
        return [float(v) for x in f[4:6] for v in x[2:4]]
    if suite == "staggered_jump":
        return [float(v) for v in f[1][2:4]] + numbers(f[3][3])
    raise KeyError(suite)
