"""The paper loop in both packages, side by side, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python examples/torch_paper_parity.py \
        [--steps 300] [--rows 1000] [--sizes 6 40 200 1000 2670]

Runs the reference loop (JAX, ``repro``) and the port's
``repro_torch.train.paper_loop.train`` from the same ``init_mlp`` weights
on the same numpy teacher rows, with the default DMDConfig and streaming
Grams, and prints each package's losses at the jump steps, every jump's
loss ratio and which jumps the guard reverted. Takes a few minutes at the
paper's full width.
"""
import argparse
import sys
import time

sys.path.insert(0, "src")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs.base import DMDConfig, OptimizerConfig  # noqa: E402
from repro.core import DMDAccelerator  # noqa: E402
from repro.models.mlp_net import init_mlp, mse_loss  # noqa: E402
from repro.optim import apply_updates, make_optimizer  # noqa: E402
from repro.train.step import reset_opt_state_after_jump  # noqa: E402
from repro_torch.configs.base import DMDConfig as TorchDMDConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.train import paper_loop  # noqa: E402


def reference_loop(X, Y, sizes, steps, seed):
    params = init_mlp(jax.random.PRNGKey(seed), sizes)
    opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-3))
    state = opt.init(params)
    acc = DMDAccelerator(DMDConfig())
    bufs = acc.init(params)
    grams = acc.init_grams(bufs)

    @jax.jit
    def step(p, s, t):
        loss, g = jax.value_and_grad(lambda pp: mse_loss(pp, X, Y))(p)
        u, s = opt.update(g, s, p, t)
        return apply_updates(p, u), s, loss

    losses, jumps, reverted = [], [], []
    for t in range(steps):
        params, state, loss = step(params, state, jnp.asarray(t))
        losses.append(float(loss))
        if acc.should_record(t):
            bufs, grams = acc.record(bufs, params, acc.slots(t), grams)
        if acc.should_apply(t):
            before = float(mse_loss(params, X, Y))
            copy = jax.tree_util.tree_map(lambda x: x.copy(), params)
            new, _ = acc.apply(copy, bufs, grams=grams, step=t)
            after = float(mse_loss(new, X, Y))
            jumps.append(after / before)
            if after > before:
                reverted.append(t)
                continue
            params = new
            reset = acc.reset_groups(acc.apply_groups(t))
            if reset:
                state = reset_opt_state_after_jump(
                    opt, state, params, acc.plans_for(params), reset,
                    acc.n_groups)
    return np.asarray(losses), jumps, reverted


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sizes", type=int, nargs="+",
                    default=[6, 40, 200, 1000, 2670])
    args = ap.parse_args()
    sizes = tuple(args.sizes)
    X, Y = synthetic_regression(seed=args.seed, n=args.rows, n_out=sizes[-1])

    t0 = time.perf_counter()
    ref = reference_loop(jnp.asarray(X), jnp.asarray(Y), sizes, args.steps,
                         args.seed)
    t1 = time.perf_counter()
    weights = jax.tree_util.tree_map(
        np.asarray, init_mlp(jax.random.PRNGKey(args.seed), sizes))
    port = paper_loop.train(X, Y, sizes, TorchDMDConfig(), args.steps,
                            params=params_from_jax(weights, "cpu"),
                            device="cpu")
    t2 = time.perf_counter()

    print(f"sizes {sizes}, {args.rows} rows, {args.steps} steps "
          f"(CPU walls: reference {t1 - t0:.1f} s, port {t2 - t1:.1f} s)")
    print(f"loss at step 0:   reference {ref[0][0]:.6e}  port "
          f"{port.losses[0]:.6e}")
    print(f"loss at the end:  reference {ref[0][-1]:.6e}  port "
          f"{port.losses[-1]:.6e}")
    print(f"max relative loss difference over all steps: "
          f"{np.max(np.abs(port.losses / ref[0] - 1)):.3e}")
    print(f"jump ratios  reference {np.round(ref[1], 4).tolist()}")
    print(f"             port      {np.round(port.jumps, 4).tolist()}")
    print(f"reverted     reference {ref[2]}  port {port.reverted}")


if __name__ == "__main__":
    main()
