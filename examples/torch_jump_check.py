"""Look inside each DMD jump of the port's paper loop.

    PYTHONPATH=src python examples/torch_jump_check.py [--device cuda]
        [--steps 300] [--rows 1000]

Runs the paper loop (the same steps as ``repro_torch.train.paper_loop``:
Adam, record with streaming Grams, guarded jumps, moment reset) at the
paper's full width and, at every jump, prints per DMD system:

  * how far the carried streaming Gram is from a full recompute of the
    ring buffer (``kernels/arena.py::gram``), relative to max |G|;
  * the jump length the Gram predicts (``info["jump_norm"]``) beside the
    length the combine actually produced, |w_new - w_last|;
  * the same coefficients solved on the CPU in float64 from the same Gram,
    and the loss that jump would give.

A predicted length far below the actual one means the fp32 Gram cannot
see the direction the solve chose, so the trust region does not bound
the jump.
"""
import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs.base import DMDConfig, OptimizerConfig  # noqa: E402
from repro_torch.configs.pollutant_mlp import PAPER_SIZES  # noqa: E402
from repro_torch.core import arena as arena_mod  # noqa: E402
from repro_torch.core.accelerator import DMDAccelerator  # noqa: E402
from repro_torch.core.dmd import dmd_coefficients  # noqa: E402
from repro_torch.core.paths import map_with_paths  # noqa: E402
from repro_torch.data.synthetic import synthetic_regression  # noqa: E402
from repro_torch.kernels import arena as ka  # noqa: E402
from repro_torch.models.mlp_net import init_mlp, mse_loss  # noqa: E402
from repro_torch.optim.optimizers import apply_updates, make_optimizer  # noqa: E402
from repro_torch.train.paper_loop import value_and_grad  # noqa: E402


def coefficients(cfg, bucket, gram, relax):
    sched = bucket.sched
    return dmd_coefficients(
        gram, s=sched.s, tol=cfg.tol, mode=cfg.mode, anchor=cfg.anchor,
        affine=cfg.affine, trust_region=cfg.trust_region, relax=relax,
        energy=sched.energy, atol=cfg.atol, ridge=sched.ridge)


def blend(bucket, params, flat):
    new = {seg.path: leaf for seg, leaf in
           zip(bucket.segments, arena_mod._unpack_row(bucket, flat))}
    return map_with_paths(lambda p, x: new.get(p, x), params)


@torch.no_grad()
def inspect_jump(t, cfg, acc, params, bufs, grams, X, Y):
    before = float(mse_loss(params, X, Y))
    relax = float(acc.relax_vector(t)[0])
    for key, b in acc.arena_for(params).items():
        buf, g = bufs["__arena__"][key], grams["__arena__"][key]
        seg = b.tables_on(buf.device)
        full = ka.gram(buf, seg, anchor_first=cfg.anchor == "first")
        gerr = float((g - full).abs().max() / full.abs().max())
        c, info = coefficients(cfg, b, g, relax)
        flat = ka.combine(buf, c.contiguous(), seg)
        c64, _ = coefficients(cfg, b, g.double().cpu(), relax)
        flat64 = ka.combine_ref(buf.double().cpu(), c64, seg.block_sys.cpu())
        last = buf[:, -1, :].reshape(-1).float()
        print(f"step {t} bucket {key}: |G_carried - G_full| / max|G| "
              f"{gerr:.2e}; loss before {before:.5e}, after fp32 jump "
              f"{float(mse_loss(blend(b, params, flat), X, Y)):.5e}, "
              f"after float64 solve "
              f"{float(mse_loss(blend(b, params, flat64.float().to(buf.device)), X, Y)):.5e}")
        lanes = 0
        for s in b.segments:
            n = s.lanes
            actual = float((flat[lanes:lanes + n] - last[lanes:lanes + n])
                           .norm())
            pred = float(info["jump_norm"][s.sys_start])
            step = float(info["step_rms"][s.sys_start])
            rank = int(info["rank"][s.sys_start])
            dc = float((c[s.sys_start].double().cpu()
                        - c64[s.sys_start]).abs().max())
            print(f"  {s.path:6s} rank {rank:2d} step_rms {step:.3e} "
                  f"predicted |dw| {pred:.3e} actual |dw| {actual:.3e} "
                  f"max|c32 - c64| {dc:.2e}")
            lanes += n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--rows", type=int, default=1000)
    ap.add_argument("--jumps", type=int, default=3,
                    help="inspect the first N jumps")
    args = ap.parse_args()
    dev = torch.device(args.device)
    Xn, Yn = synthetic_regression(seed=0, n=args.rows, n_out=PAPER_SIZES[-1])
    X, Y = torch.tensor(Xn, device=dev), torch.tensor(Yn, device=dev)
    params = init_mlp(torch.Generator().manual_seed(0), PAPER_SIZES,
                      device=dev)
    cfg = DMDConfig()
    opt = make_optimizer(OptimizerConfig(name="adam", lr=1e-3))
    state = opt.init(params)
    acc = DMDAccelerator(cfg, device=dev)
    bufs = acc.init(params)
    grams = acc.init_grams(bufs)
    seen = 0
    for t in range(args.steps):
        _, g = value_and_grad(params, X, Y)
        with torch.no_grad():
            u, state = opt.update(g, state, params, t)
            params = apply_updates(params, u)
        if acc.should_record(t):
            bufs, grams = acc.record(bufs, params, acc.slots(t), grams)
        if acc.should_apply(t):
            if seen < args.jumps:
                inspect_jump(t, cfg, acc, params, bufs, grams, X, Y)
                seen += 1
            with torch.no_grad():
                before = float(mse_loss(params, X, Y))
                new, _ = acc.apply(params, bufs, grams=grams, step=t)
                after = float(mse_loss(new, X, Y))
            print(f"step {t}: jump ratio {after / before:.4g}"
                  f"{' (reverted)' if after > before else ''}")
            if after <= before:
                params = new
                state = opt.init(params)


if __name__ == "__main__":
    main()
