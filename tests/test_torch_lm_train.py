"""The port's LM training path against the reference on the CPU, at small
size: attention's gradient (the port's training core, whose backward is
K7b on the card and autograd through the twin here) against ``jax.grad``
of the reference's ``blockwise_attention``; ``param_stack_dims``; remat;
the port's Trainer on the reduced TinyLlama against ``repro.train.Trainer``
(the reference's init carried by ``params_from_jax``, the same numpy
batches); bit-exact resume; the launcher and the two examples.

The LM is the reference's ``test_trainer.py`` one: 2 layers, d 32, 2 heads
of 16 over 1 kv head, vocab 128, fp32 for the tight checks.

Tolerances: attention gradients within 1e-4 absolute on O(1) values (fp32
summation order over <= 64 keys); remat bit for bit (the recomputed layer
runs the same arithmetic); the Trainers' losses to rtol 1e-5 until the
first jump (fp32 summation order in the matmuls) and 2e-3 after it (each
jump passes that noise through an eigensolve and an s-step matrix power:
the MLP Trainers' bound), the same steps jumping; bf16 logits within
4e-2 * max(1, max |logits|) (test_torch_lm.py's rule: the frameworks round
the bf16 residual stream at different places).
"""
import dataclasses
import functools
import gc
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import DMDConfig as JDMD
from repro.configs.base import OptimizerConfig as JOpt
from repro.configs.base import TrainConfig as JTrain
from repro.configs.base import reduced as j_reduced
from repro.core.schedule import DMDGroupRule as JRule
from repro.models import attention as jattn
from repro.models.transformer import LanguageModel as JLM
from repro.train import Trainer as JTrainer
from repro_torch.checkpoint import latest_step
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import DMDConfig, OptimizerConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.leafplan import plan_entries
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.core.schedule import DMDGroupRule
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import (LanguageModel, make_model,
                                            param_stack_dims)
from repro_torch.train import Trainer

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import torch_lm_train  # noqa: E402
import torch_quickstart  # noqa: E402

TOL = 1e-4
BF16_TOL = 4e-2
B, S = 4, 16                         # the Trainers' batch
SMALL = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, n_heads=2,
             n_kv_heads=1, head_dim=16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers, and
    eight threads per worker on a few cores spin against each other."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float()
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


# -- attention's gradient ----------------------------------------------------

@pytest.mark.parametrize("S_,H,K,causal,window", [
    (37, 4, 2, True, 0),              # causal, GQA rep 2
    (37, 4, 4, True, 0),              # rep 1
    (40, 4, 2, True, 8),              # sliding window
    (33, 4, 1, False, 0),             # non-causal, rep 4
    (40, 2, 2, False, 12),            # non-causal window, rep 1
])
def test_attention_grads_match_jax_grad(S_, H, K, causal, window):
    rng = np.random.default_rng(S_ + 10 * H + K + window)
    q = rng.standard_normal((2, S_, H, 16), np.float32)
    k = rng.standard_normal((2, S_, K, 16), np.float32)
    v = rng.standard_normal((2, S_, K, 16), np.float32)
    g = rng.standard_normal((2, S_, H, 16), np.float32)

    def ref_loss(q, k, v):
        out = jattn.blockwise_attention(q, k, v, causal=causal,
                                        window=window, chunk_k=16)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, window=window)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        assert a.shape == b.shape, name
        _close(a, b)


# -- the model's training surface -------------------------------------------

@functools.lru_cache(maxsize=None)
def _models(dtype="float32", remat="none"):
    jm = j_reduced(j_get_config("tinyllama-1.1b").model, dtype=dtype, **SMALL)
    tm = reduced(get_config("tinyllama-1.1b").model, dtype=dtype, **SMALL)
    jlm = JLM(jm, head_tp=False, chunk_k=16, remat=remat)
    jp = jax.tree_util.tree_map(np.asarray, jlm.init(jax.random.PRNGKey(0)))
    return jlm, jp, LanguageModel(tm, chunk_k=16, remat=remat, device="cpu")


def _tokens(seed, n=1):
    """`n` batches of Zipf-ish tokens (data/tokens.py's skew: a uniform
    draw cubed), so that the loss has something to learn."""
    u = np.random.default_rng(seed).random((n, B, S + 1))
    ids = (u ** 3 * SMALL["vocab_size"]).astype(np.int32)
    return [{"tokens": x[:, :-1], "labels": x[:, 1:]} for x in ids]


def test_param_stack_dims_match_reference():
    jlm, _, tlm = _models()
    want = jlm.param_stack_dims()
    assert tlm.param_stack_dims() == want
    assert param_stack_dims(tlm.cfg) == want
    assert make_model(tlm.cfg, device="cpu").param_stack_dims() == want
    with pytest.raises(ValueError, match="remat"):
        LanguageModel(tlm.cfg, remat="layer", device="cpu")


def _loss_and_grads(model, params, batch):
    leaves = leaves_with_paths(params)
    req = [x.detach().clone().requires_grad_(True) for _, x in leaves]
    by = {p: r for (p, _), r in zip(leaves, req)}
    tree = map_with_paths(lambda p, _: by[p], params)
    loss = model.loss(tree, batch)[0]
    return loss, torch.autograd.grad(loss, req)


@pytest.mark.parametrize("remat", ["block", "full"])
def test_remat_loss_and_grads_bit_identical(remat):
    jlm, jp, plain = _models()
    params = params_from_jax(jp, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _tokens(3)[0].items()}
    base_loss, base_grads = _loss_and_grads(plain, params, batch)
    _, _, rm = _models(remat=remat)
    loss, grads = _loss_and_grads(rm, params, batch)
    assert torch.equal(loss, base_loss)
    for a, b in zip(grads, base_grads):
        assert torch.equal(a, b)
    # the loss and every gradient against the reference's jax.grad
    jloss, jgrads = jax.value_and_grad(lambda p: jlm.loss(p, {
        k: jnp.asarray(v) for k, v in _tokens(3)[0].items()})[0])(
        jax.tree_util.tree_map(jnp.asarray, jp))
    _close(loss, jloss)
    want = dict(leaves_with_paths(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jgrads), device="cpu")))
    for (path, _), g in zip(leaves_with_paths(params), grads):
        _close(g, want[path])


def test_bf16_training_forward_within_reference_rule():
    jlm, jp, tlm = _models("bfloat16", "block")
    toks = _tokens(4)[0]
    params = params_from_jax(jp, device="cpu")
    loss, grads = _loss_and_grads(tlm, params, {
        k: torch.from_numpy(v) for k, v in toks.items()})
    jl, _ = jlm.forward(jax.tree_util.tree_map(jnp.asarray, jp),
                        {"tokens": jnp.asarray(toks["tokens"])})
    with torch.enable_grad():
        tl, _ = tlm.forward(params, {"tokens": torch.from_numpy(
            toks["tokens"])})
    scale = max(1.0, float(np.abs(np.asarray(jl)).max()))
    _close(tl.detach(), jl, BF16_TOL * scale)
    jloss, _ = jlm.loss(jax.tree_util.tree_map(jnp.asarray, jp),
                        {k: jnp.asarray(v) for k, v in toks.items()})
    _close(loss, jloss, BF16_TOL * max(1.0, abs(float(jloss))))
    assert all(torch.isfinite(g.float()).all() for g in grads)


# -- the Trainer ---------------------------------------------------------------

def _cfgs(dmd: dict, ga: int = 1, rules=(), dtype="float32"):
    """(reference ArchConfig, port ArchConfig) of the small LM, mirrored."""
    out = []
    for get, red, Cfg, Opt, Train, Rule in (
            (j_get_config, j_reduced, JDMD, JOpt, JTrain, JRule),
            (get_config, reduced, DMDConfig, OptimizerConfig, TrainConfig,
             DMDGroupRule)):
        acfg = get("tinyllama-1.1b")
        mc = red(acfg.model, dtype=dtype, **SMALL)
        out.append(dataclasses.replace(
            acfg, model=mc,
            dmd=Cfg(**dmd, groups=tuple(Rule(**r) for r in rules)),
            optimizer=Opt(name="adam", lr=3e-3, schedule="constant"),
            parallel=dataclasses.replace(acfg.parallel, grad_accum=ga,
                                         remat="none"),
            train=Train(global_batch=B, seq_len=S)))
    return out


DMD = dict(enabled=True, m=4, s=10, tol=1e-4, warmup_steps=4,
           cooldown_steps=2)


def _run_both(steps, dmd=DMD, ga=1, rules=()):
    """Both Trainers from the reference's init on the same numpy batches.
    Returns {"ref"/"port": (trainer, state, losses, jump steps)}."""
    jac, tac = _cfgs(dmd, ga, rules)
    _, jp, _ = _models()
    batches = _tokens(7, steps)
    out = {}
    for name in ("ref", "port"):
        losses, jumps = [], []

        def on_m(t, m, losses=losses, jumps=jumps):
            losses.append(float(m["loss"]))
            if "mean_rank" in m:
                jumps.append(t)
        if name == "ref":
            tr = JTrainer(JLM(jac.model, head_tp=False, chunk_k=16), jac)
            st = tr.init_state()
            params = jax.tree_util.tree_map(jnp.asarray, jp)
            st = st._replace(params=params, opt_state=tr.opt.init(params))
        else:
            tr = Trainer(LanguageModel(tac.model, chunk_k=16, device="cpu"),
                         tac, device="cpu")
            st = tr.init_state(params=params_from_jax(jp, device="cpu"))
        st = tr.fit(iter(batches), steps, state=st, on_metrics=on_m)
        out[name] = (tr, st, np.asarray(losses), jumps)
    return out


@pytest.mark.parametrize("ga", [1, 2])
def test_lm_trainer_matches_reference(ga):
    """Warm-up 4, cool-down 2, m 4: jumps at 9, 15 and 21."""
    out = _run_both(22, ga=ga)
    _, _, jl, jj = out["ref"]
    tr, st, tl, tj = out["port"]
    assert tj == jj == [9, 15, 21]
    k = tj[0] + 1                          # losses up to the first jump
    np.testing.assert_allclose(tl[:k], jl[:k], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    # one bucket per dtype: the bf16-free fp32 LM packs every leaf in one
    (bucket,) = tr.acc.arena_for(st.params).values()
    assert bucket.n_sys == 2 * 9 + 3       # 9 stacked leaves x 2 layers + 3


def test_two_group_lm_trainer_staggers_jumps():
    """The reference's two-group schedule (norm scales on m 3 / phase 1 /
    no cool-down windows, the rest on m 4 + cool-down 2): both groups
    jump on the reference's steps, and the losses agree."""
    rules = [dict(name="norms", path_regex="norm|/ln", m=3, phase=1,
                  cooldown_steps=0)]
    out = _run_both(26, rules=rules)
    tr, st, tl, tj = out["port"]
    jtr, _, jl, jj = out["ref"]
    assert tr.acc.n_groups == 2
    assert {pl.m for pl in plan_entries(tr.acc.plans_for(st.params))} == \
        {3, 4}
    jumped = {0: 0, 1: 0}
    for step in range(26):
        groups = tr.acc.apply_groups(step)
        assert tuple(groups) == tuple(jtr.acc.apply_groups(step)), step
        for g in groups:
            jumped[g] += 1
    assert jumped[0] > 0 and jumped[1] > 0 and tj == jj
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert all(torch.isfinite(x).all() for _, x in
               leaves_with_paths(st.params))


def _port_trainer(ckpt=None, fail_at=None):
    _, tac = _cfgs(DMD)
    tac = dataclasses.replace(tac, train=dataclasses.replace(
        tac.train, checkpoint_every=4 if ckpt else 0))
    return Trainer(LanguageModel(tac.model, chunk_k=16, device="cpu"), tac,
                   checkpoint_dir=ckpt, fail_at_step=fail_at, device="cpu")


def test_fit_leaves_no_tensor_in_a_reference_cycle():
    """A finished fit (DMD on, through a jump, microbatches and remat)
    leaves nothing it allocated to the garbage collector: every tensor it
    made goes with its last reference. On the card a tensor held in a
    cycle would keep the CUDA graphs' shared pool, a whole step's
    temporaries, after fit returns."""
    _, tac = _cfgs(DMD, ga=2)
    tac = dataclasses.replace(tac, parallel=dataclasses.replace(
        tac.parallel, remat="block"))
    tr = Trainer(LanguageModel(tac.model, chunk_k=16, remat="block",
                               device="cpu"), tac, device="cpu")
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        st = tr.fit(iter(_tokens(3, 12)), 12)
        gc.set_debug(gc.DEBUG_SAVEALL)
        gc.collect()
        cyclic = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        if enabled:
            gc.enable()
    assert int(st.step) == 12
    assert cyclic == []


def test_lm_failure_injection_and_bitexact_resume(tmp_path):
    """Preempted at step 8 (the second record of the first window, DMD
    on), resumed by a fresh Trainer from the step-8 checkpoint: the final
    params equal an uninterrupted run's bit for bit."""
    _, jp, _ = _models()
    batches = _tokens(9, 12)
    init = params_from_jax(jp, device="cpu")
    tr_a = _port_trainer()
    final_a = tr_a.fit(iter(batches), 12, state=tr_a.init_state(params=init))
    tr_b = _port_trainer(str(tmp_path), fail_at=8)
    with pytest.raises(RuntimeError, match="injected failure"):
        tr_b.fit(iter(batches), 12, state=tr_b.init_state(params=init))
    assert latest_step(str(tmp_path)) == 8
    tr_c = _port_trainer(str(tmp_path))
    final_c = tr_c.fit(iter(batches[8:]), 12,
                       state=tr_c.init_state(params=init))
    assert int(final_c.step) == 12
    for (path, a), (_, c) in zip(leaves_with_paths(final_a.params),
                                 leaves_with_paths(final_c.params)):
        assert torch.equal(a, c), path
    for (path, a), (_, c) in zip(leaves_with_paths(final_a.dmd_buffers),
                                 leaves_with_paths(final_c.dmd_buffers)):
        assert torch.equal(a, c), path


# -- the entry points ----------------------------------------------------------

def test_launcher_reduced_trains_with_dmd_on_cpu(capsys):
    acfg = launch_train.configure("tinyllama-1.1b", steps=40, reduced=True)
    assert acfg.dmd.enabled and acfg.dmd.warmup_steps == 10
    assert (acfg.train.global_batch, acfg.train.seq_len) == (8, 64)
    model = launch_train.make_model(acfg, reduced=True, device="cpu")
    assert model.remat == "none" and model.chunk_k == 64
    losses, jumps = [], []
    trainer, state = launch_train.run(
        acfg, model, steps=40, log_every=0,
        on_metrics=lambda t, m: (losses.append(float(m["loss"])),
                                 "mean_rank" in m and jumps.append(t)))
    assert jumps == [33] and int(state.step) == 40
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    launch_train.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                       "cpu", "--steps", "12"])
    assert "12 steps in" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        launch_train.main(["--arch", "tinyllama-1.1b", "--multi-pod",
                           "--device", "cpu"])


def test_launcher_resumes_bit_exactly_from_its_checkpoint(tmp_path):
    """``--ckpt``: the launcher checkpoints every 50 steps; a run preempted
    at step 51 and rerun resumes from step 50 and ends where an
    uninterrupted run ends, bit for bit."""
    def cfg(ckpt=""):
        return launch_train.configure("tinyllama-1.1b", steps=56,
                                      reduced=True, ckpt=ckpt)
    model = launch_train.make_model(cfg(), reduced=True, device="cpu")
    _, whole = launch_train.run(cfg(), model, steps=56, log_every=0)
    ckpt = str(tmp_path)
    with pytest.raises(RuntimeError, match="injected failure"):
        launch_train.run(cfg(ckpt), model, steps=56, ckpt=ckpt,
                         log_every=0, fail_at_step=51)
    assert latest_step(ckpt) == 50
    seen = []
    _, resumed = launch_train.run(cfg(ckpt), model, steps=56, ckpt=ckpt,
                                  log_every=0,
                                  on_metrics=lambda t, m: seen.append(t))
    assert seen == list(range(50, 56)) and int(resumed.step) == 56
    for (path, a), (_, b) in zip(leaves_with_paths(whole.params),
                                 leaves_with_paths(resumed.params)):
        assert torch.equal(a, b), path


def test_launcher_reckons_the_state_before_the_card_run():
    """TinyLlama-1.1B's state at 22 layers (bf16 params, adamw moments,
    the gradients, the fp32 ring of 14) exceeds 90% of an 80 GB card and
    raises with its bytes; the 16-layer cut fits."""
    full = launch_train.configure("tinyllama-1.1b", steps=96)
    assert full.parallel.remat == "block" and full.model.n_layers == 22
    card = 80 * 2 ** 30
    n22 = launch_train.param_count(LanguageModel(full.model, device="cpu"))
    assert n22 == 1_100_048_384
    with pytest.raises(RuntimeError, match=str(72 * n22)):
        launch_train.check_fits(full, n22, card)
    cut = launch_train.configure("tinyllama-1.1b", steps=96, n_layers=16)
    n16 = launch_train.param_count(LanguageModel(cut.model, device="cpu"))
    assert launch_train.check_fits(cut, n16, card) == 72 * n16


def test_quickstart_example_falls_with_dmd_on_cpu():
    base, dmd = torch_quickstart.main(["--device", "cpu", "--steps", "50"])
    assert len(base) == len(dmd) == 50
    assert dmd[-1] < dmd[0] and base[-1] < base[0]
    assert base[:41] == dmd[:41]          # identical until the first jump


def test_lm_train_example_falls_with_dmd_on_cpu(tmp_path):
    losses = torch_lm_train.main(["--device", "cpu", "--steps", "60",
                                  "--dmd", "--layers", "2", "--width",
                                  "128", "--seq", "64", "--ckpt",
                                  str(tmp_path)])
    assert len(losses) == 60 and np.isfinite(losses).all()
    assert np.mean(losses[-10:]) < np.mean(losses[:10])
    assert latest_step(str(tmp_path)) == 50


def test_entry_points_import_neither_jax_nor_reference():
    """The launcher and both examples in a fresh interpreter: neither
    ``jax`` nor ``repro`` ends up in sys.modules."""
    import os
    import subprocess
    code = ("import sys, importlib\n"
            "for m in ('repro_torch.launch.train', 'torch_quickstart', "
            "'torch_lm_train'):\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "examples")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
