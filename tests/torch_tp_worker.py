"""The rank side of tests/test_torch_tensor_parallel.py: tensor-parallel
compute over "model" on four gloo ranks on the CPU, in one spawn.

Imports torch and the port only (no JAX): the test process holds the
reference. ``tp_checks(rank, inputs, tmp)`` runs, for every case of
``CASES`` (small fp32 configs, one per attention / MLP / MoE / SSM /
vocabulary layout), the loss and each leaf's gradient block on a (2, 2)
mesh (or, for the cases of ``MESH_OF``, a (1, 4) one) against one
process here (``distributed/checks.py::tp_gradients``), the planted
faults and a Trainer with DMD on (2, 2); the inputs (the reference's
initial params and the numpy batches) come from the test process, so both
packages start from the same numbers.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import (DMDConfig, OptimizerConfig,
                                      TrainConfig)
from repro_torch.convert import params_from_jax
from repro_torch.core.paths import leaves_with_paths
from repro_torch.distributed import checks
from repro_torch.launch.mesh import Mesh
from repro_torch.models.transformer import LanguageModel
from repro_torch.train import Trainer

B, S = 4, 16
SMALL = dict(n_layers=2, d_model=32, d_ff=64, vocab_size=128, n_heads=4,
             n_kv_heads=2, head_dim=16, dtype="float32")


def _moe(arch: str, **kw):
    return dataclasses.replace(get_config(arch).model.moe, **kw)


# name -> (arch, reduced overrides, pad_heads_to): every layout of the
# slice on a (2, 2) mesh
CASES = {
    # GQA, K split over "model"; untied head, vocabulary 120 padded to 128
    "gqa-split": ("tinyllama-1.1b", dict(SMALL, vocab_size=120), 0),
    # MQA: one kv head, its columns all-gathered; GELU MLP, untied head
    "mqa": ("granite-20b", dict(SMALL, n_kv_heads=1), 0),
    # MHA of 6 heads padded to 8 over 2 ranks: rank 0 projects heads 0-2
    # and attends 0-3, so q, k and v move; tied head
    "mha-moved": ("minicpm-2b", dict(SMALL, d_model=48, n_heads=6,
                                     n_kv_heads=6), 4),
    # GQA 6 / 2 padded to 8 (rep 3 -> 4): each rank's groups are its own
    "gqa-padded": ("tinyllama-1.1b", dict(SMALL, n_heads=6), 4),
    # 4 experts over 2 ranks, top-2
    "moe": ("qwen3-moe-30b-a3b", dict(SMALL, moe=_moe(
        "qwen3-moe-30b-a3b", n_experts=4, top_k=2, expert_d_ff=32)), 0),
    # a dense-MoE pair, top-1 and a shared expert
    "moe-pair": ("llama4-maverick-400b-a17b", dict(SMALL, moe=_moe(
        "llama4-maverick-400b-a17b", n_experts=4, top_k=1, expert_d_ff=32,
        shared_d_ff=32)), 0),
    # Mamba-2: d_inner 64, 4 heads of 16 over 2 ranks
    "ssm": ("mamba2-2.7b", dict(n_layers=2, d_model=32, vocab_size=128,
                                dtype="float32", ssm=dataclasses.replace(
                                    get_config("mamba2-2.7b").model.ssm,
                                    state_dim=8, head_dim=16, chunk=8)), 0),
    # Zamba2: a group of 2 Mamba-2 layers, then the shared MHA block (a
    # group of 6 puts the fp32 noise of the heads' split GEMMs, amplified
    # through the SSD's exponentials, at 1-2e-5 of the largest gradient)
    "zamba": ("zamba2-2.7b", dict(SMALL, n_layers=2, shared_attn_every=2,
                                  n_kv_heads=4,
                                  ssm=dataclasses.replace(
                                      get_config("zamba2-2.7b").model.ssm,
                                      state_dim=8, head_dim=16, chunk=8)),
              0),
    # Gemma3: 5 window layers (window 8) then a global one, the logits
    # soft-capped, tied, vocabulary 120 padded
    "gemma": ("gemma3-27b", dict(SMALL, n_layers=6, vocab_size=120,
                                 sliding_window=8, logit_softcap=30.0), 0),
    # Whisper: the encoder over 16 frames, cross-attention, MHA
    "whisper": ("whisper-base", dict(SMALL, n_kv_heads=4, n_encoder_layers=2,
                                     encoder_seq_len=16), 0),
    # kv-SP (head_tp=False): every head's queries on every rank, k and v
    # split by sequence (rank 1's keys at offset 8), GQA causal
    "gqa-kvsp": ("tinyllama-1.1b", dict(SMALL), 0),
    # the same on (1, 4) over 18 tokens: blocks of 5, 5, 5 and 3 keys
    "gqa-kvsp-1x4": ("tinyllama-1.1b", dict(SMALL), 0),
    # Gemma3's window layers in kv-SP: the window (8) through the offset,
    # a query's window across both blocks
    "gemma-kvsp": ("gemma3-27b", dict(SMALL, n_layers=6, vocab_size=120,
                                      sliding_window=8, logit_softcap=30.0),
                   0),
    # Whisper as its config lays it out (head_tp None: 4 heads are no
    # multiple of 16; heads padded to 16, which neither package applies
    # to the encoder's and decoder's blocks): kv-SP throughout, the
    # encoder's self-attention and the cross-attention over 15 frames
    # (blocks of 8 and 7), the decoder's causal over 16 tokens
    "whisper-kvsp": ("whisper-base", dict(SMALL, n_kv_heads=4,
                                          n_encoder_layers=2,
                                          encoder_seq_len=15), 16),
    # head-TP (head_tp=True) with 6 heads over a "model" axis of 4, no
    # padding asked: the core's heads padded to 8 for the call, transiently
    "heads-6-over-4": ("tinyllama-1.1b", dict(SMALL, n_heads=6), 0),
}
# each case's head_tp (the reference's argument; True where not listed)
HEAD_TP = {"gqa-kvsp": False, "gqa-kvsp-1x4": False, "gemma-kvsp": False,
           "whisper-kvsp": None}
# the cases on a (1, 4) mesh ("model" 4, the batch whole on every rank);
# the others run on (2, 2)
MESH_OF = {"gqa-kvsp-1x4": "1x4", "heads-6-over-4": "1x4"}
# a case's sequence length where it is not S
SEQ = {"gqa-kvsp-1x4": 18}
# the cases run with remat="block": their blocks recompute in the backward
# inside the mesh's contexts (the MoE's batch statistics included)
REMAT = ("moe-pair", "whisper", "whisper-kvsp")
# the planted faults and the case each runs on
FAULTS = {"drop-row-sum": "gqa-split", "drop-replicated-sum": "ssm",
          "kv-sp-unweighted-merge": "gqa-kvsp",
          "kv-sp-drop-dq-sum": "gqa-kvsp"}
# the Trainer with DMD on (2, 2): the case, its steps (the first jump at 9)
TRAIN_CASE, TRAIN_STEPS = "mha-moved", 12
TRAIN_DMD = dict(enabled=True, m=4, s=10, tol=1e-4, warmup_steps=4,
                 cooldown_steps=2)


def model_cfg(name: str):
    arch, over, _ = CASES[name]
    return reduced(get_config(arch).model, **over)


def batches(name: str, n: int = 1, seed: int = 0) -> list:
    """`n` numpy batches of the case: tokens, labels, and an enc-dec's
    frames."""
    cfg = model_cfg(name)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(1, cfg.vocab_size, (B, SEQ.get(name, S) + 1))
        b = {"tokens": t[:, :-1].astype(np.int32),
             "labels": t[:, 1:].astype(np.int32)}
        if cfg.family == "encdec":
            b["frames"] = rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
        out.append(b)
    return out


def train_cfg(name: str):
    acfg = get_config(CASES[name][0])
    return dataclasses.replace(
        acfg, model=model_cfg(name), dmd=DMDConfig(**TRAIN_DMD),
        optimizer=OptimizerConfig(name="adamw", lr=3e-3,
                                  schedule="constant", weight_decay=0.1,
                                  grad_clip=1.0),
        parallel=dataclasses.replace(acfg.parallel, grad_accum=1,
                                     remat="none"),
        train=TrainConfig(global_batch=B, seq_len=S))


def head_tp(name: str):
    return HEAD_TP.get(name, True)


def _model(name: str) -> LanguageModel:
    return LanguageModel(model_cfg(name), head_tp=head_tp(name), chunk_k=16,
                         device="cpu", pad_heads_to=CASES[name][2],
                         remat="block" if name in REMAT else "none")


def _torch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree


def _case(mesh, name: str, inputs: dict, fault=None) -> dict:
    params = dict(leaves_with_paths(params_from_jax(inputs[name],
                                                    device="cpu")))
    model, batch = _model(name), _torch(batches(name)[0])
    one = checks.one_rank(model, params, batch)
    res = checks.tp_gradients(model, params, batch, mesh, fault=fault,
                              one=one, keep=fault is None)
    out = {k: res[k] for k in ("loss", "loss_one", "grad_err",
                               "grad_err_l2")}
    out["model_gathers"] = len(checks.model_param_gathers(
        res["collectives"]))
    out["sites"] = sorted({c["what"] for c in res["collectives"]
                           if c["what"] and not str(c["what"])
                           .startswith("param:")})
    if "grads" in res:
        # the mesh's gradient gathered to full and one process's, for the
        # test process to hold against the reference's
        out["grads"], out["grads_one"] = _np(res["grads"]), _np(one[1])
    return out


def _trainer(mesh, inputs) -> dict:
    """The case TRAIN_CASE trained with DMD on `mesh` (None: one process)
    from the reference's init: losses and jump steps."""
    acfg = train_cfg(TRAIN_CASE)
    tr = Trainer(_model(TRAIN_CASE), acfg, device="cpu", mesh=mesh)
    st = tr.init_state(params=params_from_jax(inputs[TRAIN_CASE],
                                              device="cpu"))
    _, losses, jumps, _ = checks.fit(
        tr, [_torch(b) for b in batches(TRAIN_CASE, TRAIN_STEPS, seed=5)],
        TRAIN_STEPS, st)
    return {"losses": losses, "jumps": jumps}


def tp_checks(rank: int, inputs: dict, tmp: str) -> dict:
    """Every rank-side check of tests/test_torch_tensor_parallel.py."""
    meshes = {"2x2": Mesh((2, 2), device="cpu"),
              "1x4": Mesh((1, 4), device="cpu")}
    out = {"rank": rank, "cases": {}, "faults": {}}
    for name in CASES:
        res = _case(meshes[MESH_OF.get(name, "2x2")], name, inputs)
        if rank != 0:
            res.pop("grads")
            res.pop("grads_one")
        out["cases"][name] = res
    for fault, name in FAULTS.items():
        out["faults"][fault] = _case(meshes[MESH_OF.get(name, "2x2")], name,
                                     inputs, fault=fault)
    mesh = meshes["2x2"]
    out["train"] = _trainer(mesh, inputs)
    if rank == 0:
        out["train_one"] = _trainer(None, inputs)
    mesh.barrier()
    return out
