"""The SSM and hybrid families' training path on the CPU: the launcher's
``run`` on reduced Mamba2 and Zamba2 (the config's DMD on every param in a
bf16 ring, m 14, through the first jump) against ``repro.train.Trainer``
from the same injected init on the port's token stream; ``check_fits``
refusing the full depths by the reckoned state; the launcher's CLI.

The models run in fp32 (``configure``'s reduced config with its dtype
replaced on both sides) so that the two frameworks' arithmetic can be
held tightly: in bf16 they round the residual stream at different places.

Tolerances: losses to rtol 1e-5 until the first jump (fp32 summation
order in the products; test_torch_lm_train.py's rule) and 2e-3 on the
jump step's loss, the same steps jumping.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.transformer import LanguageModel as JLM
from repro.train import Trainer as JTrainer
from repro_torch.convert import params_from_jax
from repro_torch.data.tokens import synthetic_lm_batches
from repro_torch.launch import train as launch_train

STEPS = 32                  # warm-up 8 (steps // 4): the jump at step 31
ARCHS = ("mamba2-2.7b", "zamba2-2.7b")
GB = 80 * 10 ** 9           # an 80 GB card's bytes, for check_fits


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _ref_acfg(arch):
    """The reference launcher's ArchConfig for the same flags."""
    acfg = j_get_config(arch)
    mc = j_reduced(acfg.model, dtype="float32")
    return dataclasses.replace(
        acfg, model=mc,
        dmd=dataclasses.replace(acfg.dmd, warmup_steps=min(
            acfg.dmd.warmup_steps, STEPS // 4)),
        train=dataclasses.replace(acfg.train, global_batch=8, seq_len=64))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_launcher_matches_reference_trainer(arch):
    acfg = launch_train.configure(arch, steps=STEPS, reduced=True)
    acfg = dataclasses.replace(acfg, model=dataclasses.replace(
        acfg.model, dtype="float32"))
    assert (acfg.dmd.m, acfg.dmd.snapshot_dtype, acfg.dmd.param_filter,
            acfg.dmd.warmup_steps, acfg.parallel.grad_accum) == \
        (14, "bfloat16", "all", 8, 8)
    jac = _ref_acfg(arch)
    jlm = JLM(jac.model, head_tp=False, chunk_k=64)
    jp = jlm.init(jax.random.PRNGKey(0))

    ref_losses, ref_jumps = [], []
    jtr = JTrainer(jlm, jac)
    st = jtr.init_state()
    st = st._replace(params=jp, opt_state=jtr.opt.init(jp))
    # the port's stream, as numpy, for both (the packages' streams share
    # their contract, not their values: data/tokens.py)
    j_final = jtr.fit(({k: jnp.asarray(v.numpy()) for k, v in b.items()}
             for b in synthetic_lm_batches(0, 8, 64, jac.model.vocab_size,
                                           device="cpu")), STEPS, state=st,
            on_metrics=lambda t, m: (ref_losses.append(float(m["loss"])),
                                     "mean_rank" in m and ref_jumps.append(t)))

    model = launch_train.make_model(acfg, reduced=True, device="cpu")
    assert model.remat == "none" and model.chunk_k == 64
    trainer = launch_train.make_trainer(acfg, model)
    state = trainer.init_state(params=params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"))
    losses, jumps = [], []
    trainer, state = launch_train.run(
        acfg, model, steps=STEPS, log_every=0, trainer=trainer, state=state,
        on_metrics=lambda t, m: (losses.append(float(m["loss"])),
                                 "mean_rank" in m and jumps.append(t)))
    assert jumps == ref_jumps == [STEPS - 1] and int(state.step) == STEPS
    np.testing.assert_allclose(losses[:-1], ref_losses[:-1], rtol=1e-5)
    np.testing.assert_allclose(losses[-1], ref_losses[-1], rtol=2e-3)
    assert np.isfinite(losses).all()      # the lr is still warming up
    # every leaf in one bf16 ring of 14, laid out as the reference's: one
    # system per Mamba layer (zamba's two stack axes give groups x 6), the
    # shared block's leaves one system each
    (bucket,) = trainer.acc.arena_for(state.params).values()
    (ref,) = jtr.acc.arena_for(j_final.params).values()
    assert (bucket.m, bucket.n_sys, bucket.n_blocks) == \
        (ref.m, ref.n_sys, ref.n_blocks)
    assert bucket.m == 14 and bucket.n_sys >= 14 * acfg.model.n_layers


@pytest.mark.parametrize("arch,full,cut", [
    ("mamba2-2.7b", 64, 34), ("zamba2-2.7b", 54, 29)])
def test_check_fits_refuses_full_depth(arch, full, cut):
    """44 B a param (bf16 param, adamw's fp32 moments, fp32 sum and bf16
    gradient, the bf16 ring of 14): the full depths exceed 90% of an 80
    GB card, the depths chip_smoke.py trains do not."""
    for n, ok in ((full, False), (cut, True)):
        acfg = launch_train.configure(arch, steps=100, n_layers=n)
        model = launch_train.make_model(acfg, device="cpu")
        n_p = launch_train.param_count(model)
        assert sum(launch_train.state_bytes(acfg, n_p).values()) == 44 * n_p
        if ok:
            assert launch_train.check_fits(acfg, n_p, GB) == 44 * n_p
        else:
            with pytest.raises(RuntimeError, match="cut the depth"):
                launch_train.check_fits(acfg, n_p, GB)
    if arch.startswith("zamba"):
        assert [s.kind for s in launch_train.make_model(
            launch_train.configure(arch, steps=4, n_layers=33),
            device="cpu").plan] == ["zamba", "mamba"]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_cli_reduced_on_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--reduced", "--steps", "4",
                       "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 steps in" in out and "batch=8x64" in out

