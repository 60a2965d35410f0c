"""How far the DMD loops move under fp32-level nudges, and which
eigensolver the port's DMD solve needs to move as the reference does.

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/torch_noise_floor.py \
        [--case fig4|launcher]
    PYTHONPATH=src python examples/torch_noise_floor.py --case card

``--case fig4`` (the default; CPU, both packages): the fig3/fig4 loop
(``_train``: no guard, every jump recomputing the Gram and resetting the
moments) at fig4's size ((6, 40, 200, 400), 600 teacher rows, 600 steps,
m 14, s 55, tol 1e-4) from the port's seeded init, scaled by 1 + k * 1e-7
for k in NUDGES. The reference's ``benchmarks/paper_benches.py::_train``
(that init injected) and the port's ``repro_torch.benchmarks`` ``_train``:
per run the largest jump ratio and the final test MSE; the reference's own
envelope (per sampled step, the largest relative difference of the train
or test MSE between two of its runs: ``chip_smoke.py``'s
``FIG4_ENVELOPE``) and the spread of its first jump's ratio; and the
port's curve against the reference's from the same init. Then every Gram
the port's un-nudged run solved goes to both packages'
``dmd_coefficients``: how many systems keep the same rank, and the
largest relative difference of c.

``--case launcher`` (CPU, the reference): its ``examples/
pollutant_regression.py::train`` on its own rows (32 x 16 grid, 50
probes, split 0.8), the MLP (6, 16, 40, 50), the launcher's DMD (m 14,
s 55, warmup 100, cooldown 10), with its targets scaled by 1 + k * 1e-7:
at tol 1e-4 on 4 samples over 200 epochs its jump ratios per run; at tol
1e-2 on 8 samples over 240 epochs how far the nudged runs' per-epoch MSE
moves after the first accepted jump (``tests/test_torch_launch.py``).

``--case card`` (the port alone, on a CUDA card; imports no JAX): the
port's fig4 ``_train`` on the card from the same inits, with its DMD
solve's eigendecomposition as shipped (the host's LAPACK,
``core/dmd.py::_lag_eigh``) and with cuSOLVER's (``torch.linalg.eigh`` on
the card) swapped in: per run the largest jump ratio and the final test
MSE; the shipped card run against the port's CPU run from the same init;
per eigensolver the ms of one (6, 13, 13) eigh, and the controller
suite's jump-step walls.
"""
import argparse
import contextlib
import importlib.util
import io
import subprocess
import sys
import time

sys.path[:0] = ["src", "."]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.benchmarks import paper_benches as P  # noqa: E402
from repro_torch.configs.base import DMDConfig  # noqa: E402
from repro_torch.core import arena as arena_mod  # noqa: E402
from repro_torch.core import dmd as tdmd  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.models.mlp_net import init_mlp  # noqa: E402

DMD = dict(m=14, s=55, tol=1e-4, warmup_steps=100, cooldown_steps=10)
SIZES, STEPS = (6, 40, 200, 400), 600
NUDGES = (0, 1, -1, 2, -2, 3, -3, 5, -5, 10, -10)      # times 1e-7


def _fig4_inputs():
    X, Y = synthetic_regression(n=900)
    split = (X[:600], Y[:600], X[750:], Y[750:])
    init = init_mlp(torch.Generator().manual_seed(0), SIZES, device="cpu")
    return split, init


def _scaled(init, k):
    return {a: {b: v * (1 + k * 1e-7) for b, v in d.items()}
            for a, d in init.items()}


def _port(split, params, device):
    curve, jumps = P._train(DMDConfig(**DMD), SIZES, *split, STEPS,
                            params=params, device=device)
    return np.asarray(curve), jumps


def _rel(a, b):
    """Per sampled step, the larger relative difference of the train and
    test MSE of curve `a` from curve `b`."""
    return np.abs(a[:, 1:] / b[:, 1:] - 1).max(axis=1)


def _line(who, k, curve, jumps):
    print(f"{who}, init x (1 + {k}e-7): largest jump ratio "
          f"{max(jumps):.4g}, final test MSE {curve[-1, 2]:.6g}")


def fig4():
    import jax
    import jax.numpy as jnp
    from benchmarks import paper_benches as R
    from repro.configs.base import DMDConfig as JCfg
    from repro.core import dmd as jdmd

    split, init = _fig4_inputs()
    first = 123                                 # the schedule's first jump
    ref = {}
    for k in NUDGES:
        jinit = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                       _scaled(init, k))
        R.init_mlp = lambda key, s, p=jinit: p
        curve, jumps = R._train(JCfg(**DMD), SIZES,
                                *(jnp.asarray(a) for a in split), STEPS)
        ref[k] = (np.asarray(curve), jumps)
        _line("reference", k, *ref[k])
    base = ref[0][0]
    steps = base[:, 0]
    curves = [c for c, _ in ref.values()]
    env = np.max([_rel(a, b) for a in curves for b in curves if a is not b],
                 axis=0)
    firsts = [j[0] for _, j in ref.values()]
    print(f"reference envelope (largest relative difference of the train or "
          f"test MSE between two of these {len(ref)} runs) per sampled step "
          f"{steps.astype(int).tolist()}: {np.round(env, 4).tolist()}; first"
          f" jump ratios {min(firsts):.6g}-{max(firsts):.6g} "
          f"({max(firsts) / min(firsts) - 1:.3g} apart); finals "
          f"{min(c[-1, 2] for c in curves):.6g}-"
          f"{max(c[-1, 2] for c in curves):.6g}")
    solves = []
    solve = arena_mod.dmd_math.dmd_coefficients

    def recorded(gram, **kw):
        solves.append((gram.clone(), kw))
        return solve(gram, **kw)

    for k in NUDGES:
        if k == 0:
            arena_mod.dmd_math.dmd_coefficients = recorded
        try:
            curve, jumps = _port(split, _scaled(init, k), "cpu")
        finally:
            arena_mod.dmd_math.dmd_coefficients = solve
        _line("port (CPU)", k, curve, jumps)
        rel = _rel(curve, ref[k][0])
        print(f"  against the reference's run from that init: "
              f"{rel[steps < first].max():.3g} before step {first}, "
              f"{rel[steps > first].max():.4g} after it; first jump ratio "
              f"{abs(jumps[0] / ref[k][1][0] - 1):.3g}")
    eps = np.finfo(np.float32).eps
    own_eigh = tdmd._lag_eigh

    def ref_eigh(g_lag):
        w, v = jnp.linalg.eigh(jnp.asarray(g_lag.numpy()))
        return torch.from_numpy(np.array(w)), torch.from_numpy(np.array(v))
    same, n, worst, spreads, given = 0, 0, 0.0, [], []
    for gram, kw in solves:
        kw = {a: b for a, b in kw.items() if a not in ("s_dyn", "ridge_dyn")}
        kw["relax"] = float(np.asarray(kw["relax"]))
        g = gram.numpy()
        tc, tinfo = tdmd.dmd_coefficients(gram, **kw)
        jc, jinfo = jdmd.dmd_coefficients(jnp.asarray(g), **kw)
        jc, top = np.asarray(jc), np.abs(np.asarray(jc)).max(axis=-1)
        same += int((tinfo["rank"].numpy() == np.asarray(jinfo["rank"]))
                    .sum())
        n += g.shape[0]
        worst = max(worst, float((np.abs(tc.numpy() - jc).max(axis=-1)
                                  / top).max()))
        spread = np.max([np.abs(np.asarray(jdmd.dmd_coefficients(
            jnp.asarray(g * np.float32(1 + k * eps)), **kw)[0]) - jc)
            .max(axis=-1) for k in (1, -1, 2, -2)], axis=0)
        spreads += list(spread / top)
        tdmd._lag_eigh = ref_eigh
        try:
            gc, _ = tdmd.dmd_coefficients(gram, **kw)
        finally:
            tdmd._lag_eigh = own_eigh
        given += list(np.abs(gc.numpy() - jc).max(axis=-1) / spread)
    print(f"the port's {len(solves)} Grams solved by both packages: the same"
          f" rank in {same} of {n} systems, c apart by at most {worst:.3g} "
          f"of its largest entry; the reference's own c moves by "
          f"{min(spreads):.3g}-{max(spreads):.3g} of its largest entry when "
          f"the Gram is scaled by 1 +- eps or 1 +- 2 eps; given the "
          f"reference's eigenpairs, the port's c is at most {max(given):.3g}"
          f" of that move from the reference's")


def launcher():
    import jax.numpy as jnp
    from repro.configs.base import DMDConfig as JCfg
    from repro.data import pollutant as jpol

    spec = importlib.util.spec_from_file_location(
        "_ref_pollutant_example", "examples/pollutant_regression.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for n_samples, tol, epochs in ((4, 1e-4, 200), (8, 1e-2, 240)):
        data = jpol.generate_dataset(n_samples=n_samples, nx=32, ny=16,
                                     n_points=50, n_iter=5000, seed=0,
                                     batch=4)
        (Xtr, Ytr), (Xte, Yte) = jpol.train_test_split(data, 0.8)
        runs = {}
        for k in (0, 1, -1, 3, -3):
            with contextlib.redirect_stdout(io.StringIO()):
                _, tr, te, jumps = mod.train(
                    *(jnp.asarray(a) for a in (Xtr, Ytr * (1 + k * 1e-7),
                                               Xte, Yte)),
                    (6, 16, 40, 50), JCfg(**{**DMD, "tol": tol}), epochs,
                    log_every=1)
            runs[k] = (np.stack([np.asarray(tr)[:, 1], np.asarray(te)[:, 1]],
                                axis=1), jumps)
            print(f"reference, {n_samples} samples, tol {tol:g}, targets x "
                  f"(1 + {k}e-7): jump ratios {np.round(jumps, 4).tolist()}")
        base, jb = runs[0]
        acc = [t for t, r in zip(range(123, epochs, 24), jb) if r <= 1.0]
        if acc:
            move = max(np.abs(c / base - 1)[acc[0]:].max()
                       for k, (c, _) in runs.items() if k)
            print(f"  first accepted jump {acc[0]}; the nudged runs' "
                  f"per-epoch MSE moves by up to {move:.4g} from there on")


def _ms(fn, reps=50):
    """Median host ms of fn() over `reps` synchronised calls."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def card():
    if not torch.cuda.is_available():
        sys.exit("--case card needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    split, init = _fig4_inputs()
    shipped = tdmd._lag_eigh

    def cusolver(g):
        return torch.linalg.eigh(g)

    a = torch.randn((6, 14, 400), generator=torch.Generator().manual_seed(0))
    lag = (a @ a.transpose(-1, -2))[:, :13, :13].cuda()
    cpu, _ = _port(split, init, "cpu")
    for name, eigh in (("host LAPACK (shipped)", shipped),
                       ("cuSOLVER", cusolver)):
        tdmd._lag_eigh = eigh
        try:
            print(f"{name}: eigh of a (6, 13, 13) fp32 stack on the card "
                  f"{_ms(lambda: eigh(lag))} ms (median of 50)")
            for k in NUDGES:
                t0 = time.perf_counter()
                curve, jumps = _port(split, _scaled(init, k), "cuda")
                wall = time.perf_counter() - t0
                _line(f"port on the card, {name}", k, curve, jumps)
                if k == 0:
                    rel = _rel(curve, cpu)
                    print(f"  {wall:.3f} s; against the port's CPU run: per "
                          f"sampled step {np.round(rel, 4).tolist()}")
            rows = P.controller(device="cuda")
            print(f"  {[r for r in rows if 'jump_step_wall_ms' in r][0]}")
        finally:
            tdmd._lag_eigh = shipped


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--case", choices=("fig4", "launcher", "card"),
                    default="fig4")
    {"fig4": fig4, "launcher": launcher, "card": card}[
        ap.parse_args().case]()
