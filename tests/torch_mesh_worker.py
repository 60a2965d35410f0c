"""The rank side of tests/test_torch_distributed.py: the checks each of
four gloo ranks on the CPU runs on the port's mesh, in one spawn.

Imports torch and the port only (no JAX): the test process holds the
reference and compares. ``mesh_checks(rank, inputs, tmp)`` returns, from
every rank, a dict of numpy results and in-rank verdicts; the inputs (the
reference's initial params, the numpy batches) come from the test
process, so both packages start from the same numbers.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (ArchConfig, DMDConfig,
                                      DMDControllerConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      TrainConfig)
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths
from repro_torch.core.schedule import DMDGroupRule
from repro_torch.distributed import checks, sharding
from repro_torch.launch.mesh import Mesh, record_collectives
from repro_torch.models.mlp_net import MLPModel
from repro_torch.models.transformer import LanguageModel
from repro_torch.train import Trainer

# the small LM (tests/test_torch_lm_train.py's, with 4 q heads: its
# compute is head-parallel over "model", and the (1, 4) mesh a run is
# restored onto splits 4 heads, where 2 would need kv-SP), fp32: its
# (2, 2) mesh run is held to the one-process run at the Trainer tests' 1e-5
SMALL = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, n_heads=4,
             n_kv_heads=1, head_dim=16, dtype="float32")
LM_B, LM_S = 4, 16
LM_DMD = dict(enabled=True, m=4, s=10, tol=1e-4, warmup_steps=4,
              cooldown_steps=2)
LM_STEPS = 12                        # the first jump at 9
# TinyLlama's optimizer family: AdamW with weight decay and the global-norm
# clip (whose norm sums each leaf's squares over the axes that shard it)
LM_OPT = dict(name="adamw", lr=3e-3, schedule="constant", weight_decay=0.1,
              grad_clip=1.0)
MLP_SIZES = (6, 16, 40, 130)
MLP_N = 64
MLP_DMD = dict(m=4, s=5, warmup_steps=5, cooldown_steps=2,
               arena_block_n=128, tol=1e-4)
MLP_STEPS = 20                       # jumps at 9, 15
# biases in a group of their own with another window (the Gram "hetero"
# variant): m 3, jumping at 8, 13, 18
HETERO = ({"name": "biases", "max_ndim": 1, "m": 3, "phase": 1,
           "cooldown_steps": 2, "s": 4},)
# the reference test's system-sharded override (tests/test_arena.py)
SYS_OVERRIDE = [(r"stacked", ("fsdp", None, "tp"))]
SYS_SHAPES = {"stacked": (4, 64, 128), "w": (64, 128)}


# ---------------------------------------------------------------------------
# Configs and inputs (shared with the test process)
# ---------------------------------------------------------------------------

def lm_cfg(ctrl: bool = False, arena: bool = True, ckpt_every: int = 0
           ) -> ArchConfig:
    acfg = get_config("tinyllama-1.1b")
    return dataclasses.replace(
        acfg, model=reduced(acfg.model, **SMALL),
        dmd=DMDConfig(**LM_DMD, arena=arena,
                      controller=DMDControllerConfig(enabled=ctrl)),
        optimizer=OptimizerConfig(**LM_OPT),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                     remat="none"),
        train=TrainConfig(global_batch=LM_B, seq_len=LM_S,
                          checkpoint_every=ckpt_every))


def mlp_cfg(ctrl: bool = False, arena: bool = True, rules=(),
            ckpt_every: int = 0) -> ArchConfig:
    return ArchConfig(
        model=ModelConfig(name="mlp", family="mlp"),
        dmd=DMDConfig(**MLP_DMD, arena=arena,
                      groups=tuple(DMDGroupRule(**r) for r in rules),
                      controller=DMDControllerConfig(enabled=ctrl)),
        optimizer=OptimizerConfig(name="adam", lr=1e-3),
        parallel=ParallelConfig(grad_accum=1),
        train=TrainConfig(global_batch=MLP_N, seq_len=1,
                          checkpoint_every=ckpt_every), shapes=())


def lm_batches(steps: int, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        t = rng.integers(1, SMALL["vocab_size"], (LM_B, LM_S + 1))
        out.append({"tokens": t[:, :-1].astype(np.int32),
                    "labels": t[:, 1:].astype(np.int32)})
    return out


def mlp_data(seed: int = 0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((MLP_N + 32, MLP_SIZES[0])).astype(np.float32)
    y = np.tanh(x @ rng.standard_normal((MLP_SIZES[0], MLP_SIZES[-1]))
                ).astype(np.float32)
    return {"x": x[:MLP_N], "y": y[:MLP_N]}, {"x": x[MLP_N:],
                                              "y": y[MLP_N:]}


def kernel_params(case: str) -> dict:
    """Full params of the kernel checks: the small LM's shapes (lane-
    sharded buckets) or the reference test's system-sharded pair."""
    if case == "sys":
        return {f"/{k}": np.zeros(s, np.float32)
                for k, s in SYS_SHAPES.items()}
    m = LanguageModel(reduced(get_config("tinyllama-1.1b").model, **SMALL),
                      device="cpu")
    return {p: np.zeros(tuple(x.shape), np.float32) for p, x in
            leaves_with_paths(m.init(torch.Generator().manual_seed(0)))}


def kernel_stack_dims(case: str) -> dict:
    if case == "sys":
        return {"/stacked": 1, "/w": 0}
    return {p: (1 if p.startswith("/seg") else 0)
            for p in kernel_params(case)}


def trajectory(case: str, m: int, dyadic: bool, seed: int) -> list:
    """m snapshots of the full params by path: integer-valued (dyadic) or
    standard normal."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m):
        snap = {}
        for p, x in sorted(kernel_params(case).items()):
            snap[p] = (rng.integers(-3, 4, x.shape).astype(np.float32)
                       if dyadic else
                       rng.standard_normal(x.shape).astype(np.float32))
        out.append(snap)
    return out


def coefficients(case: str, m: int, seed: int) -> dict:
    """{path: (stack..., m)} jump coefficients (integers: exact sums)."""
    rng = np.random.default_rng(seed)
    sd = kernel_stack_dims(case)
    return {p: rng.integers(-2, 3, x.shape[:sd[p]] + (m,)).astype(
        np.float32) for p, x in sorted(kernel_params(case).items())}


# ---------------------------------------------------------------------------
# Rank side
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _numpy(tree):
    """Tensors of a checks result -> numpy (the ranks' results travel by
    pickle to the test process)."""
    if isinstance(tree, torch.Tensor):
        return _np(tree)
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree


def _kernels(mesh, case: str, arena: bool, dyadic: bool,
             device="cpu") -> dict:
    """``checks.data_passes`` on `mesh` over the case's numpy trajectory
    and coefficients (the reference's inputs in the test process)."""
    sharding.set_rule_overrides(SYS_OVERRIDE if case == "sys" else None)
    try:
        traj = trajectory(case, checks.M, dyadic, seed=3 + int(dyadic))
        coeffs = coefficients(case, checks.M, seed=11)
        res = checks.data_passes(
            mesh, {p: x.shape for p, x in kernel_params(case).items()},
            kernel_stack_dims(case), arena=arena, device=device,
            block_n=128,
            snapshot=lambda j: {p: torch.from_numpy(x).to(device)
                                for p, x in traj[j].items()},
            coefficients={p: torch.from_numpy(x).to(device)
                          for p, x in coeffs.items()})
        return _numpy(res)
    finally:
        sharding.set_rule_overrides(None)


def _gradsync(mesh) -> dict:
    """int8_psum_grads on a (2, 1, 2) pod mesh: the replicated case (every
    pod holds the same gradient) and pods that differ."""
    return _numpy(checks.int8_sync(mesh, (8, 8), "cpu"))


def _int8_trainer(pods, inputs) -> dict:
    """The MLP on the (2, 1, 2) pod mesh with ``grad_compression="int8"``
    and without: the losses of both."""
    train, _ = mlp_data()
    out = {}
    for comp in ("none", "int8"):
        acfg = mlp_cfg()
        acfg = dataclasses.replace(acfg, parallel=dataclasses.replace(
            acfg.parallel, grad_compression=comp))
        tr = _mlp_trainer(acfg, pods, None)
        st = tr.init_state(params=params_from_jax(inputs["mlp_init"],
                                                  device="cpu"))
        with record_collectives() as rec:
            _, losses, jumps, _ = checks.fit(tr, [_torch_batch(train)] * 12,
                                             12, st)
        out[comp] = {"losses": losses, "jumps": jumps,
                     "int32_pod": sum(1 for c in rec if c["dtype"] == "int32"
                                      and c["axes"] == ("pod",))}
    return out


def _full_params(trainer: Trainer, state) -> dict:
    return _numpy(checks.full_params(trainer, state))


def _lm_trainer(acfg, mesh, ckpt=None):
    return Trainer(LanguageModel(acfg.model, chunk_k=16, device="cpu"), acfg,
                   device="cpu", mesh=mesh, checkpoint_dir=ckpt)


def _mlp_trainer(acfg, mesh, val, ckpt=None):
    return Trainer(MLPModel(MLP_SIZES), acfg, device="cpu", mesh=mesh,
                   checkpoint_dir=ckpt,
                   val_batch=val if acfg.dmd.controller.enabled else None)


def _torch_batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _parity(mesh, inputs) -> dict:
    """The small LM and the MLP on the (2, 2) mesh from the reference's
    init: losses, jump steps, gate outcomes, the full final params, and
    the coefficient digests of every rank."""
    out = {}
    lm_b = [_torch_batch(b) for b in lm_batches(LM_STEPS)]
    train, val = mlp_data()
    mlp_b = [_torch_batch(train)] * MLP_STEPS
    runs = {
        "lm": lambda: (_lm_trainer(lm_cfg(), mesh), inputs["lm_init"], lm_b,
                       LM_STEPS),
        "lm-ctrl": lambda: (_lm_trainer(lm_cfg(ctrl=True), mesh),
                            inputs["lm_init"], lm_b, LM_STEPS),
        "mlp": lambda: (_mlp_trainer(mlp_cfg(), mesh, None),
                        inputs["mlp_init"], mlp_b, MLP_STEPS),
        "mlp-perleaf": lambda: (_mlp_trainer(mlp_cfg(arena=False), mesh,
                                             None),
                                inputs["mlp_init"], mlp_b, MLP_STEPS),
        "mlp-ctrl": lambda: (_mlp_trainer(mlp_cfg(ctrl=True), mesh,
                                          _torch_batch(val)),
                             inputs["mlp_init"], mlp_b, MLP_STEPS),
    }
    for name, make in runs.items():
        tr, init, batches, steps = make()
        coeffs = checks.CoefficientLog(mesh)
        st = tr.init_state(params=params_from_jax(init, device="cpu"))
        st, losses, jumps, outcomes = checks.fit(tr, batches, steps, st)
        coeffs.close()
        out[name] = {"losses": losses, "jumps": jumps, "outcomes": outcomes,
                     "params": _full_params(tr, st),
                     "c_before": coeffs.before, "c_after": coeffs.after}
    return out


def _planted_fault(mesh, inputs) -> dict:
    """The small LM on the (2, 2) mesh with a planted fault: the backward
    of the params' gather keeps each rank's own rows' gradient (the sum
    over the batch axes dropped), so each data rank trains on its half of
    every batch. The parity checks must fail it."""
    from repro_torch.train import step as step_mod

    fn = step_mod._GatherParam
    real = fn.__dict__["backward"]

    def own_rows(ctx, g):
        return (sharding.local_shard(g.contiguous(), ctx.spec, ctx.mesh),
                None, None, None, None, None)
    fn.backward = staticmethod(own_rows)
    try:
        tr = _lm_trainer(lm_cfg(), mesh)
        st = tr.init_state(params=params_from_jax(inputs["lm_init"],
                                                  device="cpu"))
        st, losses, jumps, outcomes = checks.fit(
            tr, [_torch_batch(b) for b in lm_batches(LM_STEPS)], LM_STEPS,
            st)
        return {"losses": losses, "jumps": jumps, "outcomes": outcomes,
                "params": _full_params(tr, st)}
    finally:
        fn.backward = real


# -- elastic restores ------------------------------------------------------

# the controller preempted on its jump step and mid-window (the MLP), the
# resident arena of the small LM (lane-sharded buckets), and the Gram
# variants keep / zero / hetero (the MLP)
ELASTIC = ("ctrl-jump", "ctrl-mid", "resident", "gram-keep", "gram-zero",
           "gram-hetero")
# the step a save is written at (the checkpoint holds steps 0 .. at - 1):
# after the MLP's jump step 10 (the gate's step), mid-window after two
# records of a window (the MLP's first at 9 and second at 15, the LM's
# second at 14)
SAVE_AT = {"ctrl-jump": 11, "ctrl-mid": 9, "resident": 14, "gram-keep": 15,
           "gram-zero": 15, "gram-hetero": 15}
TARGETS = ("4x1", "1x4", "one")


def _elastic_cfg(case: str):
    if case == "resident":
        return lm_cfg()
    if case.startswith("ctrl"):
        return mlp_cfg(ctrl=True)
    return mlp_cfg(rules=HETERO if case == "gram-hetero" else ())


def _elastic_trainer(case, mesh, inputs, ckpt=None):
    acfg = _elastic_cfg(case)
    if case == "resident":
        return _lm_trainer(acfg, mesh, ckpt), inputs["lm_init"], \
            [_torch_batch(b) for b in lm_batches(LM_STEPS + 4)], \
            LM_STEPS + 4
    train, val = mlp_data()
    return _mlp_trainer(acfg, mesh, _torch_batch(val), ckpt), \
        inputs["mlp_init"], [_torch_batch(train)] * MLP_STEPS, MLP_STEPS


def _strip_grams(step_dir: Path) -> None:
    """The pre-streaming format: a checkpoint without its Gram leaves."""
    man = json.loads((step_dir / "manifest.json").read_text())
    man["leaves"] = {k: v for k, v in man["leaves"].items()
                     if not k.startswith(".dmd_gram")}
    (step_dir / "manifest.json").write_text(json.dumps(man))


def _elastic(rank, inputs, tmp, meshes) -> dict:
    out = {}
    for case in ELASTIC:
        ckpt = str(Path(tmp) / f"elastic-{case}")
        tr, init, batches, steps = _elastic_trainer(case, meshes["2x2"],
                                                    inputs)
        st0 = tr.init_state(params=params_from_jax(init, device="cpu"))
        _, losses, jumps, _ = checks.fit(tr, batches, steps, st0)
        # the same run, saved after SAVE_AT (a SIGTERM on rank 0 alone,
        # which every rank must follow)
        tr, _, _, _ = _elastic_trainer(case, meshes["2x2"], inputs, ckpt)
        st0 = tr.init_state(params=params_from_jax(init, device="cpu"))

        def preempt(t, m, tr=tr, at=SAVE_AT[case]):
            if t == at - 1 and rank == 0:
                tr._preempted = True
        st, _, _, _ = checks.fit(tr, batches, steps, st0,
                                 on_metrics=preempt)
        saved = int(st.step)
        if case == "gram-zero" and rank == 0:
            _strip_grams(Path(ckpt) / f"step_{saved}")
        meshes["2x2"].barrier()
        res = {"uninterrupted": losses, "jumps": jumps, "saved": saved}
        for target in TARGETS:
            mesh = meshes.get(target)
            if target == "one" and rank != 0:
                continue
            tr, _, _, _ = _elastic_trainer(case, mesh, inputs, ckpt)
            restored = tr.restore()
            grams = checks.gram_errors(tr, restored)
            st, l2, j2, _ = checks.fit(tr, batches, steps, restored)
            res[target] = {"losses": l2, "jumps": j2, "start":
                           int(restored.step), "gram_err": grams,
                           "params": _full_params(tr, st)}
        meshes["2x2"].barrier()
        out[case] = res
    return out


def mesh_checks(rank: int, inputs: dict, tmp: str) -> dict:
    """Every rank-side check of tests/test_torch_distributed.py."""
    meshes = {"2x2": Mesh((2, 2), device="cpu"),
              "4x1": Mesh((4, 1), device="cpu"),
              "1x4": Mesh((1, 4), device="cpu"),
              "1x2": Mesh((1, 2), device="cpu")}
    pods = Mesh((2, 1, 2), ("pod", "data", "model"), device="cpu")
    out = {"rank": rank, "kernels": {}}
    for mesh_name in ("2x2", "1x2"):
        mesh = meshes[mesh_name]
        if mesh.rank is None:
            continue
        for case in ("lm", "sys"):
            for arena in (True, False):
                for dyadic in (True, False):
                    key = (mesh_name, case, arena, dyadic)
                    out["kernels"][key] = _kernels(mesh, case, arena, dyadic)
    meshes["2x2"].barrier()
    out["gradsync"] = _gradsync(pods)
    out["int8_trainer"] = _int8_trainer(pods, inputs)
    out["parity"] = _parity(meshes["2x2"], inputs)
    out["fault"] = _planted_fault(meshes["2x2"], inputs)
    out["elastic"] = _elastic(rank, inputs, tmp, meshes)
    out["audit"] = checks.mesh_audit((2, 2), "cpu")
    return out


def card_kernel_checks(rank: int) -> dict:
    """tests/test_torch_gpu.py's: two ranks sharing the card (gloo on CUDA
    tensors), the kernels' data passes per block on a (1, 2) mesh, every
    case of ``_kernels``; returns the verdicts and the largest relative
    difference of the mesh's Grams from one rank's."""
    mesh = Mesh((1, 2), device="cuda")
    out = {}
    for case in ("lm", "sys"):
        for arena in (True, False):
            for dyadic in (True, False):
                r = _kernels(mesh, case, arena, dyadic, device="cuda")
                err = max(float(np.abs(r["streamed"][p] - r["one"][p]).max()
                                / max(np.abs(r["one"][p]).max(), 1e-30))
                          for p in r["one"])
                out[(case, arena, dyadic)] = {
                    "err": err,
                    "exact": all(r["streamed_equal_one"].values()),
                    "k2": all(r["k2_slice_equal"].values()) and all(
                        r.get("k2_bucket_equal", {0: True}).values()),
                    "allreduce_only": all(
                        k == "all_reduce" for rec in r["record_collectives"]
                        for k, _ in rec)}
    return out
