"""The whole slice: the port's paper loop against a JAX loop built here from
the reference's public pieces (the reference example's guarded loop, but
carrying streaming Grams as the reference's Trainer does; the example and
the benchmarks' ``_train`` carry none and recompute the Gram at every
jump, which ``test_torch_launch.py`` and ``test_torch_benches.py`` hold),
on injected ``init_mlp`` weights and the shared numpy teacher, plus the
pieces the loop is made of.

Tolerances: up to the first jump the losses agree to rtol 1e-5 (fp32
summation order in the matmuls). Each jump passes that noise through an
eigensolve and an s-step matrix power, so from then on rtol 2e-3; the
jump decisions (accepted or reverted) and counts must agree exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.paper_benches import _synthetic_regression
from repro.configs.base import DMDConfig as JCfg, OptimizerConfig as JOpt
from repro.core import DMDAccelerator as JAcc
from repro.core.schedule import DMDGroupRule as JRule
from repro.models.mlp_net import init_mlp as j_init, mse_loss as j_mse
from repro.models.mlp_net import mlp_forward as j_forward
from repro.optim import apply_updates as j_apply, make_optimizer as j_make
from repro.train.step import reset_opt_state_after_jump as j_reset
from repro_torch.configs.base import DMDConfig as TCfg, OptimizerConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.accelerator import DMDAccelerator as TAcc
from repro_torch.core.schedule import DMDGroupRule as TRule
from repro_torch.data.synthetic import synthetic_regression
from repro_torch.models.mlp_net import MLPNet, init_mlp, mse_loss
from repro_torch.optim.optimizers import apply_updates, make_optimizer
from repro_torch.train import paper_loop
from repro_torch.train.step import reset_opt_state_after_jump

SIZES = (6, 16, 40, 130)


def _jax_loop(X, Y, cfg, steps, params):
    opt = j_make(JOpt(name="adam", lr=1e-3))
    state = opt.init(params)
    acc = JAcc(cfg)
    bufs = acc.init(params)
    grams = acc.init_grams(bufs)

    @jax.jit
    def step(p, s, t):
        loss, g = jax.value_and_grad(lambda pp: j_mse(pp, X, Y))(p)
        u, s = opt.update(g, s, p, t)
        return j_apply(p, u), s, loss

    losses, jumps, reverted = [], [], []
    for t in range(steps):
        params, state, loss = step(params, state, jnp.asarray(t))
        losses.append(float(loss))
        if acc.should_record(t):
            bufs, grams = acc.record(bufs, params, acc.slots(t), grams)
        if acc.should_apply(t):
            before = float(j_mse(params, X, Y))
            # apply donates its params argument on the CPU: pass a copy
            copy = jax.tree_util.tree_map(lambda x: x.copy(), params)
            new, _ = acc.apply(copy, bufs, grams=grams, step=t)
            after = float(j_mse(new, X, Y))
            jumps.append(after / before)
            if after > before:
                reverted.append(t)
                continue
            params = new
            reset = acc.reset_groups(acc.apply_groups(t))
            if reset:
                state = j_reset(opt, state, params, acc.plans_for(params),
                                reset, acc.n_groups)
    return np.asarray(losses), jumps, reverted


@pytest.mark.parametrize("variant", ["streaming", "recompute", "staggered",
                                     "perleaf", "perleaf-recompute"])
def test_paper_loop_matches_reference_loop(variant):
    X, Y = synthetic_regression(seed=0, n=64, n_out=SIZES[-1])
    kw = dict(m=4, s=5, warmup_steps=5, cooldown_steps=2, arena_block_n=128,
              streaming_gram=not variant.endswith("recompute"),
              arena=not variant.startswith("perleaf"))
    jrules = trules = ()
    if variant == "staggered":
        # biases in their own group, jumping between the matrices' jumps
        # and keeping their moments (a cooldown-free schedule would be
        # chaotic: the reference alone moves 0.5% from a 1e-7 nudge)
        rule = dict(name="biases", max_ndim=1, m=4, phase=3,
                    cooldown_steps=2, s=4, reset_opt=False)
        jrules, trules = (JRule(**rule),), (TRule(**rule),)
    jcfg = JCfg(groups=jrules, **kw)
    tcfg = TCfg(groups=trules, **kw)
    steps = 30
    jparams = j_init(jax.random.PRNGKey(0), SIZES)
    jl, jj, jr = _jax_loop(jnp.asarray(X), jnp.asarray(Y), jcfg, steps,
                           jparams)
    res = paper_loop.train(
        X, Y, SIZES, tcfg, steps, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"))
    first_jump = next(t for t in range(steps) if res.acc.should_apply(t))
    assert len(res.jumps) == len(jj) >= 3
    assert res.reverted == jr
    np.testing.assert_allclose(res.losses[:first_jump + 1],
                               jl[:first_jump + 1], rtol=1e-5)
    np.testing.assert_allclose(res.losses, jl, rtol=2e-3)
    np.testing.assert_allclose(res.jumps, jj, rtol=2e-3)
    assert res.losses[-1] < res.losses[0]


def test_mlp_and_adam_match_reference():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(32, 6)).astype(np.float32)
    Y = rng.normal(size=(32, 130)).astype(np.float32)
    jp = j_init(jax.random.PRNGKey(3), SIZES)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    np.testing.assert_allclose(
        float(mse_loss(tp, torch.tensor(X), torch.tensor(Y))),
        float(j_mse(jp, jnp.asarray(X), jnp.asarray(Y))), rtol=1e-6)
    net = MLPNet(tp)
    assert net.as_dict()["l1"]["w"].data_ptr() == tp["l1"]["w"].data_ptr()
    np.testing.assert_allclose(
        net(torch.tensor(X)).detach().numpy(),
        np.asarray(jax.jit(j_forward)(jp, jnp.asarray(X))),
        rtol=1e-5, atol=1e-6)
    grads = {lk: {k: torch.tensor(rng.normal(size=v.shape).astype(
        np.float32)) for k, v in d.items()} for lk, d in tp.items()}
    jgrads = jax.tree_util.tree_map(lambda g: jnp.asarray(g.numpy()), grads)
    for name in ("adam", "sgd", "momentum"):
        jopt = j_make(JOpt(name=name, lr=1e-2))
        topt = make_optimizer(OptimizerConfig(name=name, lr=1e-2))
        js, ts = jopt.init(jp), topt.init(tp)
        jq, tq = jp, tp
        for step in range(3):
            ju, js = jopt.update(jgrads, js, jq, jnp.asarray(step))
            tu, ts = topt.update(grads, ts, tq, step)
            jq, tq = j_apply(jq, ju), apply_updates(tq, tu)
        for lk in tp:
            for k in tp[lk]:
                np.testing.assert_allclose(tq[lk][k].numpy(),
                                           np.asarray(jq[lk][k]),
                                           rtol=1e-6, atol=1e-7,
                                           err_msg=f"{name} {lk}/{k}")


def test_group_masked_moment_reset_matches_reference():
    jcfg = JCfg(groups=(JRule(name="biases", max_ndim=1, m=3),))
    tcfg = TCfg(groups=(TRule(name="biases", max_ndim=1, m=3),))
    jp = j_init(jax.random.PRNGKey(4), SIZES)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jopt, topt = j_make(JOpt()), make_optimizer(OptimizerConfig())
    js = jax.tree_util.tree_map(jnp.ones_like, jopt.init(jp))
    ts = type(topt.init(tp))(*(
        {lk: {k: torch.ones_like(v) for k, v in d.items()}
         for lk, d in field.items()} for field in topt.init(tp)))
    jacc, tacc = JAcc(jcfg), TAcc(tcfg, device="cpu")
    for groups in ((0,), (1,), (0, 1)):
        want = j_reset(jopt, js, jp, jacc.plans_for(jp), groups,
                       jacc.n_groups)
        got = reset_opt_state_after_jump(topt, ts, tp, tacc.plans_for(tp),
                                         groups, tacc.n_groups)
        for fw, fg in zip(want, got):
            for lk in tp:
                for k in tp[lk]:
                    np.testing.assert_array_equal(fg[lk][k].numpy(),
                                                  np.asarray(fw[lk][k]))


def test_data_and_init():
    X, Y = synthetic_regression(seed=3, n=20, n_out=7)
    jX, jY = _synthetic_regression(seed=3, n=20, n_out=7)
    np.testing.assert_array_equal(X, np.asarray(jX))
    np.testing.assert_array_equal(Y, np.asarray(jY))
    p = init_mlp(torch.Generator().manual_seed(0), (6, 40, 3), device="cpu")
    assert p["l0"]["w"].shape == (6, 40) and p["l1"]["b"].shape == (3,)
    std = float(p["l0"]["w"].std())
    assert 0.5 * (2 / 46) ** 0.5 < std < 1.5 * (2 / 46) ** 0.5
    assert float(p["l0"]["b"].abs().sum()) == 0.0
    bf = params_from_jax({"a": np.asarray(jnp.ones(3, jnp.bfloat16))}, "cpu")
    assert bf["a"].dtype == torch.bfloat16


@pytest.mark.parametrize("flags", [[], ["--no-arena"],
                                   ["--no-arena", "--no-streaming"]])
def test_cli_runs_on_cpu(capsys, flags):
    paper_loop.main(["--steps", "3", "--rows", "8", "--device", "cpu",
                     *flags])
    out = capsys.readouterr().out
    assert "3 steps" in out and "0 jumps" in out


def test_entry_points_refuse_missing_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, Y = synthetic_regression(n=4, n_out=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_loop.train(X, Y, (6, 4, 3), TCfg(), 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TAcc(TCfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_mlp(torch.Generator(), (6, 4, 3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"a": np.ones(3, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        paper_loop.main(["--steps", "1", "--rows", "4", "--no-arena"])
