"""The port's paper benches (``repro_torch.benchmarks``) against the
reference's ``benchmarks/paper_benches.py`` on the CPU, at small size.

- ``_train`` (the fig3/fig4 loop: no guard, every jump recomputes the Gram
  and resets the moments) against the reference's ``_train`` itself, on
  the MLP (6, 16, 40, 130), 100 teacher rows, m 4, s 5, warmup 55,
  cooldown 10, 120 steps (jumps at 68, 82, 96, 110), with the reference's
  init injected: the curve agrees to rtol 1e-5 before the first jump
  (steps 0 and 50) and to 2e-3 after it, the jump ratios to 2e-3, the
  jump counts exactly. Unguarded jumps compound the fp32 noise each one
  amplifies, so the run stops after four (measured 4.2e-4 at step 119).
- Every Gram the port's fig4 DMD run solves (``_train`` at fig4's full
  size, (6, 40, 200, 400), 600 rows, 600 steps, m 14, s 55, tol 1e-4: 20
  jumps of 6 systems), solved by both packages' ``dmd_coefficients``.
  There the reference's own c moves by 8.5% to 99 times its largest
  entry when the Gram is scaled by 1 +- 2^-23 or 1 +- 2^-22: the
  rank mask reads eigenvalue ratios down to tol^2 = 1e-8, under fp32's
  1.2e-7. Given the reference's eigenpairs of X^T X, the port's solve
  keeps the reference's rank in every system and gives its c to a tenth
  of that spread (measured 0.013 of it): the rank rule, the operator, its
  power, the trust region and the anchor fold are the reference's. With
  its own eigenpairs (the host's LAPACK) it keeps the reference's rank in
  107 of the 120 systems, and another only where an eigenvalue lies
  within fp32's resolution (13 * eps * lambda_max) of the mask's
  threshold, where the eigensolver's rounding decides.
- ``_train_gated`` (the Trainer with fig4's validation gate) against the
  reference's at the same size (64 / 32 / 32 rows, m 4, s 55, 150 steps:
  jumps at 113, 127, 141): the outcome counts exactly, the held-out
  curve to rtol 2e-3 (the Trainer tests' bound; measured 1.7e-4).
- Each of the six suites at a reduced size against the reference suite at
  the same arguments: the same rows with the same fields and labels;
  schedule-determined and analytic rows (fig3's jump counts, fig4's steps
  and gate-outcome total, the controller's sampled steps and gated jump
  steps, sec3's op counts, streaming_gram's FLOP and byte rows,
  staggered_jump's FLOPs, concurrency, jump steps and buffer bytes) the
  same strings; every number finite and every measured one positive. The
  inits differ (torch generator, ``jax.random``), so measured values are
  not compared.
- ``python -m repro_torch.benchmarks.run --device cpu --quick`` writes the
  six files with the reference's keys.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks import paper_benches as R
from repro.configs.base import DMDConfig as JCfg
from repro.models.mlp_net import init_mlp as j_init
from repro_torch.benchmarks import paper_benches as P
from repro_torch.benchmarks import run as bench_run
from repro_torch.configs.base import DMDConfig
from repro_torch.convert import params_from_jax
from repro_torch.data.synthetic import synthetic_regression

SIZES = (6, 16, 40, 130)


def _ref_init():
    return params_from_jax(jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(0), SIZES)), "cpu")


def _np(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("route", ["arena", "perleaf", "off"])
def test_train_matches_reference(route):
    X, Y = synthetic_regression(seed=0, n=100, n_out=SIZES[-1])
    Xte, Yte = synthetic_regression(seed=7, n=40, n_out=SIZES[-1])
    kw = dict(m=4, s=5, tol=1e-4, warmup_steps=55, cooldown_steps=10,
              arena_block_n=128, arena=route == "arena",
              enabled=route != "off")
    steps = 120
    jc, jj = R._train(JCfg(**kw), SIZES, *_np(X, Y, Xte, Yte), steps)
    tc, tj = P._train(DMDConfig(**kw), SIZES, X, Y, Xte, Yte, steps,
                      params=_ref_init(), device="cpu")
    jc, tc = np.asarray(jc), np.asarray(tc)
    np.testing.assert_array_equal(tc[:, 0], [0, 50, 100, 119])
    np.testing.assert_array_equal(tc[:, 0], jc[:, 0])
    np.testing.assert_allclose(tc[:2, 1:], jc[:2, 1:], rtol=1e-5)
    np.testing.assert_allclose(tc[:, 1:], jc[:, 1:], rtol=2e-3)
    assert len(tj) == len(jj) == (0 if route == "off" else 4)
    np.testing.assert_allclose(tj, jj, rtol=2e-3)
    assert np.isfinite(tc).all()


def test_fig4_grams_solve_as_the_reference(monkeypatch):
    from repro.core import dmd as jdmd
    from repro_torch.core import arena as arena_mod
    from repro_torch.core import dmd as tdmd
    solves = []
    solve = arena_mod.dmd_math.dmd_coefficients

    def recorded(gram, **kw):
        solves.append((gram.clone(), kw))
        return solve(gram, **kw)
    monkeypatch.setattr(arena_mod.dmd_math, "dmd_coefficients", recorded)
    X, Y, _, _, Xte, Yte = P.fig4_split()
    _, jumps = P._train(DMDConfig(**P.FIG4_DMD), (6, 40, 200, 400), X, Y,
                        Xte, Yte, 600, device="cpu")
    monkeypatch.undo()
    assert len(solves) == len(jumps) == 20
    eps = np.finfo(np.float32).eps
    own_eigh = tdmd._lag_eigh
    lags = []

    def ref_eigh(g_lag):
        lags.append(g_lag.clone())
        w, v = jnp.linalg.eigh(jnp.asarray(g_lag.numpy()))
        return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(v))
    for gram, kw in solves:
        assert kw["s_dyn"] is None and kw["ridge_dyn"] is None
        kw = {k: v for k, v in kw.items() if k not in ("s_dyn", "ridge_dyn")}
        kw["relax"] = float(np.asarray(kw["relax"]))
        g = gram.numpy()
        jc, jinfo = jdmd.dmd_coefficients(jnp.asarray(g), **kw)
        jc, jrank = np.asarray(jc), np.asarray(jinfo["rank"])
        spread = np.max([np.abs(np.asarray(jdmd.dmd_coefficients(
            jnp.asarray(g * np.float32(1 + k * eps)), **kw)[0]) - jc)
            .max(axis=-1) for k in (1, -1, 2, -2)], axis=0)
        assert (spread > 0).all()
        lags.clear()
        monkeypatch.setattr(tdmd, "_lag_eigh", ref_eigh)
        tc, tinfo = tdmd.dmd_coefficients(gram, **kw)
        monkeypatch.setattr(tdmd, "_lag_eigh", own_eigh)
        np.testing.assert_array_equal(tinfo["rank"].numpy(), jrank)
        assert (np.abs(tc.numpy() - jc).max(axis=-1) <= 0.1 * spread).all()
        # with its own eigenpairs the ranks part only where an eigenvalue
        # lies within fp32's resolution of the mask's threshold
        _, tinfo = tdmd.dmd_coefficients(gram, **kw)
        jw = np.asarray(jnp.linalg.eigh(jnp.asarray(lags[0].numpy()))[0])
        k = jw.shape[-1]
        top = jw.max(axis=-1, keepdims=True)
        near = (np.abs(jw - kw["tol"] ** 2 * top) <= k * eps * top).sum(-1)
        assert (np.abs(tinfo["rank"].numpy() - jrank) <= near).all()


def test_train_gated_matches_reference():
    X, Y = synthetic_regression(seed=0, n=128, n_out=SIZES[-1])
    split = [X[:64], Y[:64], X[64:96], Y[64:96], X[96:], Y[96:]]
    steps = 150
    jc, jo = R._train_gated(SIZES, *_np(*split), steps, m=4, s=55)
    tc, to, graphs = P._train_gated(SIZES, *split, steps, m=4, s=55,
                                    params=_ref_init(), device="cpu")
    assert to == jo
    assert sum(to.values()) == 3 and len({k for k, v in to.items() if v}) > 1
    assert graphs == {}                     # the CPU captures no graph
    jc, tc = np.asarray(jc), np.asarray(tc)
    np.testing.assert_array_equal(tc[:, 0], jc[:, 0])
    np.testing.assert_allclose(tc[:3, 1:], jc[:3, 1:], rtol=1e-5)
    np.testing.assert_allclose(tc[:, 1:], jc[:, 1:], rtol=2e-3)


# -- the suites' rows ---------------------------------------------------------

# (BENCH suite name, function, reduced arguments)
SUITE_CASES = [
    ("fig3", "fig3_sensitivity", dict(ms=(4,), ss=(5,), steps=150)),
    ("fig4", "fig4_curves", dict(steps=150)),
    ("controller", "controller",
     dict(steps=150, sizes=(6, 16, 40, 50), m=4, s=10)),
    ("sec3_overhead", "sec3_overhead", dict(m=4, t_samples=16)),
    ("streaming_gram", "streaming_gram", dict(m=4, n=4096, reps=2)),
    ("staggered_jump", "staggered_jump",
     dict(sizes=(6, 40, 40, 40), reps=2)),
]


@pytest.mark.parametrize("suite,fn,kw", SUITE_CASES,
                         ids=[s for s, _, _ in SUITE_CASES])
def test_suite_rows_match_reference(suite, fn, kw):
    ref = getattr(R, fn)(**kw)
    port = getattr(P, fn)(device="cpu", **kw)
    assert P.schema_errors(port, ref) == []
    assert P.fixed_fields(suite, port) == P.fixed_fields(suite, ref)
    measured = P.measured_values(suite, port)
    assert measured and all(v > 0 for v in measured), measured


def test_schema_errors_catch_a_changed_row():
    rows = ["s,metric,a,b", "s,x,1.5,2 jumps", "s,y,-,accept=1"]
    assert P.schema_errors(rows, rows) == []
    assert P.schema_errors(rows[:2], rows)
    assert P.schema_errors(["s,metric,a,c"] + rows[1:], rows)
    assert P.schema_errors([rows[0], "s,x,1.5,2 leaps", rows[2]], rows)
    assert P.schema_errors([rows[0], "s,x,inf,2 jumps", rows[2]], rows)
    assert P.schema_errors([rows[0], "s,x,1.5", rows[2]], rows)
    assert P.schema_errors(rows[:2] + ["s,y,-,reject=1"], rows) == []


def test_run_writes_six_suites_with_the_reference_keys(tmp_path, capsys):
    bench_run.main(["--device", "cpu", "--quick", "--out", str(tmp_path)])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == sorted(f"BENCH_torch_{s}.json" for s in (
        "fig3", "fig4", "controller", "sec3_overhead", "streaming_gram",
        "staggered_jump"))
    for name in names:
        doc = json.loads((tmp_path / name).read_text())
        assert {"suite", "rows", "wall_s", "quick", "backend",
                "n_devices"} <= set(doc)
        assert doc["quick"] is True and doc["backend"] == "cpu"
        assert doc["card"] is None and doc["wall_s"] > 0
        assert name == f"BENCH_torch_{doc['suite']}.json" and doc["rows"]
    fig3 = json.loads((tmp_path / "BENCH_torch_fig3.json").read_text())
    assert [r.split(",")[-1] for r in fig3["rows"][1:]] == \
        ["12", "12", "8", "8"]
    assert "# total bench wall" in capsys.readouterr().out
    assert bench_run.losing_rows(["a,x_LOSES", "b,x_WINS"]) == ["a,x_LOSES"]
