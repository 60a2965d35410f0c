"""The port's data modules against the reference's, on the CPU: the paper's
PDE dataset (``data/pollutant.py``) and the synthetic token stream
(``data/tokens.py``), then the paper loop trained on the reference's
reduced pollutant dataset.

Tolerances:

- The numpy pieces (LHS, params, probes, grid, sources, split) and the
  Blasius shooting are the reference's own arithmetic, per sample in the
  same order: bit-identical (``assert_array_equal``).
- The march: XLA fuses the reference's stencil and rounds some sums
  differently from torch's one-op-at-a-time kernels. After 300 fixed steps
  the fields agree to rtol 1e-5 with atol 1e-7 (measured: 6.5e-7 relative,
  3.7e-9 absolute). Converged at tol 1e-5, each sample stops at the same
  iteration in both packages (measured: equal; off by one is allowed, not
  seen) and c3 agrees within 5 * tol absolute (measured: 5.6e-9).
- A sample's march does not depend on the batch it is in: bit for bit.
- ``generate_dataset``: X, params_raw and probes exact; Y (normalised,
  O(1)) within atol 1e-5, rtol 1e-5; y_mean and y_scale to rtol 1e-5.
- The whole slice: the paper loop's losses to rtol 1e-5 up to the second
  jump (measured: 4.7e-6 in the window after the first), the same jump
  decisions, and from the second jump on to rtol 1e-2 (measured: 6.4e-3).
  On these rows the jumps amplify fp32 noise more than on the teacher
  (``test_torch_paper_loop.py`` holds 2e-3 there): the reference against
  itself, with its inputs moved by a relative 1e-7, moves its losses by
  3.0e-3 on these 3 rows (6.7e-3 on 8 rows, 3.4e-3 on 16), so 2e-3 would
  test noise, not the port.
- Tokens: the port's stream is its own (``jax.random`` cannot be
  reproduced in torch), so the contract is held, not the values.

Time: ~65 s on one worker. The reference's scalar shooting (about 1.1 s
a sample, twice per sample in its ``generate_dataset``) is ~30 s of it,
run once in module fixtures; the port's vectorised shooting takes ~2 s
for any batch of a few samples (it is overhead-bound; 2000 samples take
~5 s).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import DMDConfig as JCfg
from repro.data import pollutant as R
from repro.data import tokens as jtokens
from repro.models.mlp_net import init_mlp as j_init
from repro_torch.configs import get_config
from repro_torch.configs.base import (ArchConfig, DMDConfig,
                                      DMDControllerConfig, TrainConfig,
                                      reduced)
from repro_torch.convert import params_from_jax
from repro_torch.data import pollutant as P
from repro_torch.data import tokens
from repro_torch.launch import pollutant_regression
from repro_torch.models.transformer import LanguageModel
from repro_torch.train import Trainer, paper_loop
from test_torch_paper_loop import _jax_loop

NX, NY = 32, 16
DX, DY = 2.0 / (NX - 1), 1.0 / (NY - 1)
# (U0, uh, uv) corners of the box: no slip, and U0 -> 0.01 with |uh| and
# |uv| at 0.2, which hit both clips. No point of the box takes the 0.4696
# fallback: the slip values are clipped into fp0 in [-0.5, 1.5], f0 in
# [-2, 2], and a 41 x 41 scan of that rectangle (and 2000 LHS samples)
# always finds a bracket. A NaN slip value does take it, in both packages.
CORNERS = [(1.0, 0.0, 0.0), (0.01, 0.2, 0.2), (0.01, -0.2, 0.2),
           (0.01, 0.2, -0.2), (0.01, -0.2, -0.2), (1.0, float("nan"), 0.0)]
LATER_JUMPS_RTOL = 1e-2
DATASET = dict(n_samples=3, nx=NX, ny=NY, n_points=50, n_iter=5000, seed=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def shots():
    """8 LHS samples and the corners as float32 (as the dataset's params
    are), each shot by the reference's scalar solver and all at once by
    the port."""
    p = P.sample_params(8, seed=0)
    cases = np.concatenate([p[:, 3:], np.asarray(CORNERS, np.float32)])
    ref = [R.solve_blasius(*row) for row in cases]
    return cases, ref, P.solve_blasius_batch(*cases.T)


@pytest.fixture(scope="module")
def fields():
    """Velocity fields of 4 LHS samples on the 32 x 16 grid (the port's,
    bit-identical to the reference's) and the grid's sources."""
    p = P.sample_params(4, seed=0)
    X, Y = P.make_grid(NX, NY)
    eta, f, fp = P.solve_blasius_batch(p[:, 3], p[:, 4], p[:, 5])
    ux, uy = zip(*(P.velocity_field(r[3], r[4], r[5], X, Y,
                                    (eta, f[i], fp[i]))
                   for i, r in enumerate(p)))
    return p, np.stack(ux), np.stack(uy), P.source_fields(X, Y)


@pytest.fixture(scope="module")
def ref_dataset():
    return R.generate_dataset(batch=3, **DATASET)


def _ref_march(fields, n_iter, tol, n=3):
    p, ux, uy, (q1, q2) = fields
    f = jax.jit(jax.vmap(lambda a, b, D, K12, K3: R.steady_transport(
        a, b, D, K12, K3, q1, q2, DX, DY, n_iter=n_iter, tol=tol)))
    return [np.asarray(c) for c in f(ux[:n], uy[:n], p[:n, 2], p[:n, 0],
                                     p[:n, 1])]


def _march(fields, n_iter, tol, rows=slice(0, 3)):
    p, ux, uy, (q1, q2) = fields
    return P.march(_t(ux[rows]), _t(uy[rows]), _t(p[rows, 2]),
                   _t(p[rows, 0]), _t(p[rows, 1]), _t(q1), _t(q2), DX, DY,
                   n_iter, tol)


# -- the numpy pieces ---------------------------------------------------------

@pytest.mark.parametrize("piece", [
    lambda m: m.latin_hypercube(16, 3, seed=4),
    lambda m: m.latin_hypercube(7, 1, seed=0),
    lambda m: m.sample_params(50, seed=3),
    lambda m: m.probe_points(2670, seed=1),
    lambda m: m.make_grid(96, 48),
    lambda m: m.source_fields(*m.make_grid(40, 20)),
    lambda m: np.asarray([m.NU] + [v for k in m.PARAM_ORDER
                                   for v in m.PARAM_RANGES[k]]),
], ids=["lhs", "lhs-1d", "params", "probes", "grid", "sources", "ranges"])
def test_numpy_pieces_are_the_references(piece):
    for got, want in zip(np.atleast_1d(piece(P)), np.atleast_1d(piece(R))):
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(got, want)
    assert P.PARAM_ORDER == R.PARAM_ORDER


def test_train_test_split_is_the_references():
    rng = np.random.default_rng(0)
    data = {"X": rng.normal(size=(11, 6)), "Y": rng.normal(size=(11, 4))}
    for got, want in zip(P.train_test_split(data, 0.8),
                         R.train_test_split(data, 0.8)):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- Blasius ------------------------------------------------------------------

@pytest.mark.parametrize("i", range(8 + len(CORNERS)))
def test_solve_blasius_batch_is_bit_identical_per_sample(shots, i):
    cases, ref, (eta, f, fp) = shots
    r_eta, r_f, r_fp = ref[i]
    np.testing.assert_array_equal(eta, r_eta)
    np.testing.assert_array_equal(f[i], r_f)
    np.testing.assert_array_equal(fp[i], r_fp)
    if i < 8 + 5:                        # LHS samples and the box corners
        assert abs(fp[i, -1] - 1.0) < 1e-6
    else:                                # the NaN case: the fallback
        assert np.isnan(cases[i, 1])


def test_velocity_field_is_the_references(fields):
    p = fields[0]
    X, Y = P.make_grid(NX, NY)
    for r in p[:1]:
        got = P.velocity_field(r[3], r[4], r[5], X, Y)
        want = R.velocity_field(r[3], r[4], r[5], X, Y)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)


# -- the march ----------------------------------------------------------------

def test_march_fixed_iterations_matches_reference(fields):
    want = _ref_march(fields, 300, 0.0)
    *got, iters = _march(fields, 300, 0.0)
    assert iters.tolist() == [300, 300, 300]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)


def test_march_converged_matches_reference_iteration_counts(fields):
    tol, cap = 1e-5, 5000
    final = _ref_march(fields, cap, tol)
    *got, iters = _march(fields, cap, tol)
    assert (iters < cap).all()

    def ref_done(i, k):
        """Has the reference's sample i stopped by iteration k?"""
        return all(np.array_equal(a[i], b[i]) for a, b in
                   zip(_ref_march(fields, int(k), tol), final))
    for i, n in enumerate(iters.tolist()):
        if ref_done(i, n - 1):                   # stopped one step earlier
            assert not ref_done(i, n - 2), (i, n)
        else:                                    # at n, or one step later
            assert ref_done(i, n) or ref_done(i, n + 1), (i, n)
        np.testing.assert_allclose(got[2][i].numpy(), final[2][i], rtol=0,
                                   atol=5 * tol)


def test_march_does_not_depend_on_the_batch(fields):
    *together, it = _march(fields, 5000, 1e-5, slice(0, 4))
    for i in range(4):
        *alone, it1 = _march(fields, 5000, 1e-5, slice(i, i + 1))
        assert int(it1[0]) == int(it[i])
        for a, t in zip(alone, together):
            assert torch.equal(a[0], t[i])
    c3 = P.steady_transport(*(_t(a) for a in (fields[1][:1], fields[2][:1],
                                              fields[0][:1, 2],
                                              fields[0][:1, 0],
                                              fields[0][:1, 1],
                                              *fields[3])), DX, DY,
                            n_iter=5000)[2]
    assert torch.equal(c3[0], together[2][0])


# -- the dataset --------------------------------------------------------------

def test_generate_dataset_matches_reference(ref_dataset):
    got = P.generate_dataset(batch=1, device="cpu", **DATASET)
    assert got.keys() == ref_dataset.keys()
    for key in ("X", "params_raw", "probes"):
        assert got[key].dtype == ref_dataset[key].dtype
        np.testing.assert_array_equal(got[key], ref_dataset[key])
    assert got["Y"].shape == (3, 50) and got["Y"].dtype == np.float32
    np.testing.assert_allclose(got["Y"], ref_dataset["Y"], rtol=1e-5,
                               atol=1e-5)
    for key in ("y_mean", "y_scale"):
        np.testing.assert_allclose(got[key], ref_dataset[key], rtol=1e-5)
    assert np.abs(got["X"]).max() <= 1.0


def test_solve_dataset_reports_the_march(ref_dataset):
    data, solve = P.solve_dataset(device="cpu", **DATASET)
    assert solve.c3.shape == (3, NX, NY) and solve.iters.shape == (3,)
    assert (solve.iters > 0).all() and (solve.iters < 5000).all()
    assert solve.shoot_s > 0 and solve.march_s > 0
    assert (solve.c3 >= 0).all() and solve.c3.max() > 1e-5


# -- the whole slice ----------------------------------------------------------

def test_paper_loop_on_pollutant_data_matches_reference_loop(ref_dataset):
    sizes = (6, 16, 40, 50)
    X, Y = ref_dataset["X"], ref_dataset["Y"]
    kw = dict(m=4, s=5, warmup_steps=5, cooldown_steps=2, arena_block_n=128)
    steps = 30
    jparams = j_init(jax.random.PRNGKey(0), sizes)
    jl, jj, jr = _jax_loop(jnp.asarray(X), jnp.asarray(Y), JCfg(**kw), steps,
                           jparams)
    res = paper_loop.train(
        X, Y, sizes, DMDConfig(**kw), steps, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"),
        test=(X[:1], Y[:1]))
    jumps = [t for t in range(steps) if res.acc.should_apply(t)]
    assert len(res.jumps) == len(jj) == len(jumps) >= 3
    assert res.reverted == jr
    # through the first jump and the window after it
    np.testing.assert_allclose(res.losses[:jumps[1] + 1], jl[:jumps[1] + 1],
                               rtol=1e-5)
    np.testing.assert_allclose(res.jumps[0], jj[0], rtol=1e-5)
    np.testing.assert_allclose(res.losses, jl, rtol=LATER_JUMPS_RTOL)
    np.testing.assert_allclose(res.jumps, jj, rtol=LATER_JUMPS_RTOL)
    assert [t for t, _, _ in res.curve] == [0, steps - 1]
    assert all(np.isfinite(c[1:]).all() for c in res.curve)


def test_launcher_runs_on_cpu(capsys):
    pollutant_regression.main(["--samples", "5", "--epochs", "130",
                               "--grid", "16", "8", "--points", "20",
                               "--device", "cpu"])
    out = capsys.readouterr().out
    assert "5 samples: shooting" in out and "at the cap" in out
    assert "train (4, 6) -> (4, 20), test (1, 6)" in out
    assert out.count("epoch     0:") == 2 and out.count("epoch   129:") == 2
    assert "final test  MSE: baseline" in out and "over 1 jumps" in out
    # --full is the paper's run at its scale (its config and sizes are
    # held against the reference's in test_full_config_matches_reference)
    got = _port_full_run(monkeypatch_ctx())
    assert (got["samples"], got["grid"], got["epochs"]) == \
        (1000, (96, 48), [3000, 3000])
    assert got["cfgs"][1].mode == "eig" and got["cfgs"][1].tol == 1e-10


def test_paper_loop_cli_trains_on_pollutant_data(capsys):
    paper_loop.main(["--data", "pollutant", "--rows", "2", "--steps", "3",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "2 samples: shooting" in out and "3 steps" in out


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: P.generate_dataset(n_samples=1),
                 lambda: P.solve_dataset(n_samples=1),
                 lambda: tokens.batch_for_step(0, 0, 1, 4, 10),
                 lambda: paper_loop.main(["--data", "pollutant", "--rows",
                                          "1", "--steps", "1"]),
                 lambda: pollutant_regression.main(["--samples", "1"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# -- tokens -------------------------------------------------------------------

def test_tokens_are_a_pure_function_of_seed_and_step():
    b1 = tokens.batch_for_step(0, 5, 4, 16, 100, device="cpu")
    b2 = tokens.batch_for_step(0, 5, 4, 16, 100, device="cpu")
    for k in b1:
        assert torch.equal(b1[k], b2[k])
    for other in (tokens.batch_for_step(0, 6, 4, 16, 100, device="cpu"),
                  tokens.batch_for_step(1, 5, 4, 16, 100, device="cpu")):
        assert not torch.equal(b1["tokens"], other["tokens"])
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_token_batch_shapes_dtypes_and_range_match_reference():
    kw = dict(mrope=True, frames=(3, 8))
    got = tokens.batch_for_step(7, 2, 4, 64, 1000, device="cpu", **kw)
    want = jtokens.batch_for_step(7, 2, 4, 64, 1000, **kw)
    assert got.keys() == want.keys()
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    ids = got["tokens"]
    assert int(ids.min()) >= 0 and int(ids.max()) < 1000
    # Zipf-ish: u**3 puts half the ids below vocab / 8
    assert float((ids < 125).float().mean()) > 0.4
    assert torch.equal(got["positions"][1, 2], torch.arange(64,
                                                            dtype=torch.int32))


def test_validation_fold_is_disjoint_from_training_stream():
    assert tokens.VAL_FOLD == jtokens.VAL_FOLD == 1 << 30
    val = tokens.validation_batch(3, 2, 32, 500, device="cpu")
    again = tokens.batch_for_step(3, tokens.VAL_FOLD, 2, 32, 500,
                                  device="cpu")
    assert torch.equal(val["tokens"], again["tokens"])
    other = tokens.validation_batch(3, 2, 32, 500, index=1, device="cpu")
    assert not torch.equal(val["tokens"], other["tokens"])
    stream = tokens.synthetic_lm_batches(3, 2, 32, 500, device="cpu")
    for step in range(20):
        b = next(stream)
        assert torch.equal(b["tokens"], tokens.batch_for_step(
            3, step, 2, 32, 500, device="cpu")["tokens"])
        assert not torch.equal(b["tokens"], val["tokens"])


def test_trainer_gates_a_vocab_model_on_the_validation_fold():
    mc = reduced(get_config("tinyllama-1.1b").model, dtype="float32")
    acfg = ArchConfig(model=mc, dmd=DMDConfig(
        controller=DMDControllerConfig(enabled=True)),
        train=TrainConfig(global_batch=2, seq_len=16, seed=3))
    tr = Trainer(LanguageModel(mc, device="cpu"), acfg, device="cpu")
    want = tokens.validation_batch(3, 2, 16, mc.vocab_size, device="cpu")
    assert tr.val_batch.keys() == want.keys()
    for k in want:
        assert torch.equal(tr.val_batch[k], want[k])



# -- the paper's own configuration (--full) ------------------------------------

class monkeypatch_ctx:
    """A MonkeyPatch undone when the call that uses it returns."""

    def __init__(self):
        self.mp = pytest.MonkeyPatch()

    def __enter__(self):
        return self.mp

    def __exit__(self, *exc):
        self.mp.undo()


def _tiny_data(n_samples, n_points, **_):
    rng = np.random.default_rng(0)
    return {"X": rng.uniform(-1, 1, (n_samples, 6)).astype(np.float32),
            "Y": rng.normal(size=(n_samples, n_points)).astype(np.float32)}


def _port_full_run(ctx):
    """The port's ``pollutant_regression --full`` with the dataset and the
    training runs replaced by recorders: the sizes and configs it asks
    for."""
    got = {"cfgs": [], "epochs": []}

    def gen(**kw):
        got["samples"], got["grid"] = kw["n_samples"], (kw["nx"], kw["ny"])
        return _tiny_data(**kw)

    def run(Xtr, Ytr, Xte, Yte, sizes, cfg, epochs, device):
        got["sizes"] = sizes
        got["cfgs"].append(cfg)
        got["epochs"].append(epochs)
        return paper_loop.TrainResult(None, None, None, None, np.zeros(1),
                                      [], [], [(0, 1.0, 1.0)])
    with ctx as mp:
        mp.setattr(P, "generate_dataset", gen)
        mp.setattr(pollutant_regression, "run", run)
        pollutant_regression.main(["--full", "--device", "cpu"])
    return got


@pytest.fixture
def x64():
    """``jax_enable_x64`` on for one test, then back as it was, so the
    other tests on the same worker run as before."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _ref_full_run(monkeypatch):
    """The reference's ``examples/pollutant_regression.py --full`` with its
    dataset and training replaced by recorders (it turns x64 on: run it
    under the ``x64`` fixture)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "pollutant_regression.py"
    spec = importlib.util.spec_from_file_location("_ref_pollutant_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = {"cfgs": [], "epochs": []}

    def gen(**kw):
        got["samples"], got["grid"] = kw["n_samples"], (kw["nx"], kw["ny"])
        return _tiny_data(**kw)

    def train(Xtr, Ytr, Xte, Yte, sizes, cfg, epochs, **kw):
        got["sizes"] = sizes
        got["cfgs"].append(cfg)
        got["epochs"].append(epochs)
        return None, [(0, 1.0)], [(0, 1.0)], []
    monkeypatch.setattr(mod.pol, "generate_dataset", gen)
    monkeypatch.setattr(mod, "train", train)
    monkeypatch.setattr("sys.argv", ["pollutant_regression.py", "--full"])
    mod.main()
    assert jax.config.jax_enable_x64            # --full turned it on
    return got


def test_full_config_matches_reference(x64, monkeypatch):
    """``--full`` asks for what the reference's ``--full`` asks for: 1000
    samples, the 96 x 48 grid, 3000 epochs, the paper MLP, and the same
    two DMDConfigs (DMD off, then the paper's eig-mode DMD) field by
    field; ``get_config("pollutant-mlp")`` is the reference's too."""
    import dataclasses
    from repro.configs import get_config as j_get_config
    ref = _ref_full_run(monkeypatch)
    port = _port_full_run(monkeypatch_ctx())
    for k in ("samples", "grid", "epochs", "sizes"):
        assert port[k] == ref[k], k
    assert len(port["cfgs"]) == len(ref["cfgs"]) == 2
    for t, j in zip(port["cfgs"], ref["cfgs"]):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(get_config("pollutant-mlp")) == \
        dataclasses.asdict(j_get_config("pollutant-mlp"))


def test_full_runs_in_fp32_under_the_references_x64(x64):
    """The reference's ``--full`` turns ``jax_enable_x64`` on, yet its run
    stays fp32: ``init_mlp`` draws float32 params, Adam's moments are
    float32, the arena buffer and the jump's leaves are float32, the
    dataset's X and Y are float32, and the host eig returns complex64.
    So the port's ``--full`` (fp32, no float64 path) is the same run."""
    from repro.core import DMDAccelerator as JAcc
    from repro.core import dmd as jdmd
    from repro.optim import make_optimizer as j_make
    from repro.configs.base import OptimizerConfig as JOpt
    from repro_torch.launch.pollutant_regression import full_dmd_config
    import dataclasses
    assert jnp.zeros(1, jnp.float64).dtype == jnp.float64     # x64 is on
    sizes = (6, 8, 16, 20)
    params = j_init(jax.random.PRNGKey(0), sizes)
    leaves = jax.tree_util.tree_leaves(params)
    assert {x.dtype for x in leaves} == {jnp.dtype("float32")}
    opt_state = j_make(JOpt(name="adam", lr=1e-3)).init(params)
    floats = [x for x in jax.tree_util.tree_leaves(opt_state)
              if jnp.issubdtype(x.dtype, jnp.floating)]
    assert floats and {x.dtype for x in floats} == {jnp.dtype("float32")}
    kw = {k: v for k, v in dataclasses.asdict(full_dmd_config()).items()
          if k not in ("groups", "controller")}
    acc = JAcc(JCfg(**kw))
    bufs = acc.init(params)
    assert {b.dtype for b in bufs["__arena__"].values()} == \
        {jnp.dtype("float32")}
    rng = np.random.default_rng(0)
    p = params
    for t in range(acc.cfg.warmup_steps + acc.cfg.m):
        p = jax.tree_util.tree_map(
            lambda x: x + jnp.asarray(1e-2 * rng.normal(size=x.shape),
                                      jnp.float32), p)
        if acc.should_record(t):
            bufs, _ = acc.record(bufs, p, acc.slots(t))
    assert acc.should_apply(t)
    new, _ = acc.apply(jax.tree_util.tree_map(lambda x: x.copy(), p), bufs,
                       step=t)
    assert {x.dtype for x in jax.tree_util.tree_leaves(new)} == \
        {jnp.dtype("float32")}
    data = R.generate_dataset(n_samples=1, nx=16, ny=8, n_points=10,
                              seed=0, batch=1)
    assert data["X"].dtype == data["Y"].dtype == np.float32
    w, v, rcond = jdmd._host_eig(
        rng.normal(size=(2, 5, 5)).astype(np.float32))
    assert (w.dtype, v.dtype, rcond.dtype) == (np.complex64, np.complex64,
                                               np.float32)


def test_full_train_on_reference_rows_matches_reference_loop(ref_dataset):
    """``--full``'s DMD through the paper loop on the reference's 3-sample
    rows (MLP (6, 16, 40, 50), 80 steps: jumps at 41, 55 and 69) against
    the reference's loop with the same config. Unanchored eig-mode DMD at
    tol 1e-10 keeps fp32 noise modes: in both packages every jump blows
    the loss up and the guard reverts it, so the losses agree to rtol
    1e-5 throughout (measured 2.1e-7) and the decisions are equal."""
    import dataclasses
    from repro_torch.launch.pollutant_regression import full_dmd_config
    sizes, steps = (6, 16, 40, 50), 80
    X, Y = ref_dataset["X"], ref_dataset["Y"]
    kw = {k: v for k, v in dataclasses.asdict(full_dmd_config()).items()
          if k not in ("groups", "controller")}
    kw["arena_block_n"] = 128
    jparams = j_init(jax.random.PRNGKey(0), sizes)
    jl, jj, jr = _jax_loop(jnp.asarray(X), jnp.asarray(Y), JCfg(**kw), steps,
                           jparams)
    res = paper_loop.train(
        X, Y, sizes, DMDConfig(**kw), steps, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"))
    assert [t for t in range(steps) if res.acc.should_apply(t)] == \
        [41, 55, 69]
    assert res.reverted == jr == [41, 55, 69]
    assert len(res.jumps) == len(jj) == 3
    assert all(not (r <= 1.0) for r in res.jumps + jj)
    np.testing.assert_allclose(res.losses, jl, rtol=1e-5)