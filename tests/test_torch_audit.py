"""The port's audit layer (``repro_torch.audit``) against the reference's
(``repro.audit``), on the CPU.

The static tables must agree row for row (``plan_records``,
``plan_summary``, the plan table's columns), and the table passes
(arena-layout, schedule-conflict) and the solve budget must give the same
violations and info numbers as the reference's, clean and under the
mutations that target them. The recorded-op passes have no reference
numbers to match (an eager step records what it runs, not a jaxpr): they
are held to the port's own pins, and every one of the six mutations the
port carries must fail exactly the pass the reference names for it. The
reference's contexts are built once per module (``ref_ctxs``), from the
same configs; params cross over through ``convert.params_from_jax``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.audit import passes as rpasses
from repro.audit import registry as rregistry
from repro.audit import targets as rtargets
from repro.audit.mutations import get as ref_mutation
from repro.audit.mutations import list_mutations as ref_mutations
from repro.configs import get_config as ref_get_config
from repro.configs.pollutant_mlp import PAPER_SIZES as REF_PAPER_SIZES
from repro.core import leafplan as rleafplan
from repro.core.accelerator import DMDAccelerator as RAcc
from repro_torch.audit import __main__ as cli
from repro_torch.audit import ops as ops_mod
from repro_torch.audit import passes as tpasses
from repro_torch.audit import run_audit
from repro_torch.audit.lint import lint_paths, lint_source
from repro_torch.audit.mutations import get as get_mutation
from repro_torch.audit.mutations import list_mutations
from repro_torch.audit.registry import get_pass, list_passes
from repro_torch.audit.targets import (adhoc_context, build_context,
                                       context_for)
from repro_torch.audit import targets as ttargets
from repro_torch.configs import get_config
from repro_torch.configs.base import DMDConfig, OptimizerConfig, TrainConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import leafplan as tleafplan
from repro_torch.core.accelerator import DMDAccelerator as TAcc
from repro_torch.kernels import arena as ka
from repro_torch.models.mlp_net import MLPModel
from repro_torch.train.step import model_stack_dims

SRC = Path(__file__).resolve().parent.parent / "src"
STATIC_MUTATIONS = (None, "misalign-arena", "overlap-groups",
                    "force-leaf-solves")


@pytest.fixture(scope="module")
def ref_ctxs():
    """The reference's reduced-MLP audit contexts, clean and under the
    three mutations the static passes are compared on."""
    return {m: rtargets.build_context("pollutant-mlp", reduced=True,
                                      mutate=m)
            for m in STATIC_MUTATIONS}


def _accelerators(arch: str, reduced: bool):
    """(reference acc, port acc, reference params, port params) of one
    audit build, the port's params carried over from the reference's."""
    if arch == "pollutant-mlp":
        sizes = rtargets.REDUCED_MLP_SIZES if reduced else REF_PAPER_SIZES
        rmodel = rtargets.MLPModel(sizes)
        racfg = ref_get_config(arch)
        tmodel, tacfg = MLPModel(sizes), get_config(arch)
    else:
        rmodel, racfg, _ = rtargets._build_model_and_config(arch, reduced)
        tmodel, tacfg, _ = ttargets._build_model_and_config(arch, reduced,
                                                            "cpu")
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              device="cpu")
    sd = getattr(rmodel, "param_stack_dims", None)
    racc = RAcc(racfg.dmd, stack_dims=sd() if sd else None)
    tacc = TAcc(tacfg.dmd, stack_dims=model_stack_dims(tmodel),
                device="cpu")
    return racc, tacc, rparams, tparams


@pytest.mark.parametrize("arch,reduced", [("tinyllama-1.1b", True),
                                          ("pollutant-mlp", False)])
def test_plan_records_and_summary_match_reference(arch, reduced):
    racc, tacc, rparams, tparams = _accelerators(arch, reduced)
    rplans, tplans = racc.plans_for(rparams), tacc.plans_for(tparams)
    assert tleafplan.plan_records(tplans) == rleafplan.plan_records(rplans)
    assert tleafplan.plan_summary(tplans) == rleafplan.plan_summary(rplans)
    # no mesh: every leaf is emitted as the reference emits an unsharded one
    for row in tleafplan.plan_records(tplans):
        assert row["sharded"] is False and row["psum_axes"] == []
        assert row["param_spec"] == "PartitionSpec" + repr(
            (None,) * len(row["shape"]))


def _columns(table: str):
    """{path: {column: value}} of a rendered plan table, cut at the
    header's column starts (values may hold spaces)."""
    lines = [ln for ln in table.splitlines()
             if ln.strip() and set(ln.strip()) - {"-", " "}]
    head = lines[0]
    starts = [i for i, ch in enumerate(head)
              if ch != " " and (i == 0 or head[i - 1] == " ")]
    names = head.split()
    rows = {}
    for ln in lines[1:]:
        cells = [ln[a:b].strip() for a, b in
                 zip(starts, starts[1:] + [len(ln) + 1])]
        rows[cells[0]] = dict(zip(names, cells))
    return names, rows


@pytest.mark.parametrize("arch,reduced", [("tinyllama-1.1b", True),
                                          ("pollutant-mlp", False)])
def test_plan_table_renders_the_reference_columns(arch, reduced):
    racc, tacc, rparams, tparams = _accelerators(arch, reduced)
    rnames, rrows = _columns(racc.plan_table(rparams))
    tnames, trows = _columns(tacc.plan_table(tparams))
    assert set(rnames) <= set(tnames)
    assert tnames[-2:] == ["scope", "n_solve"]
    assert set(trows) == set(rrows)
    for path, rrow in rrows.items():
        assert {k: trows[path][k] for k in rnames} == rrow, path


def _same(rres, tres):
    rv, rinfo = rres
    tv, tinfo = tres
    assert [(v.where, v.detail, v.severity) for v in tv] == \
        [(v.where, v.detail, v.severity) for v in rv]
    assert tinfo == rinfo


@pytest.mark.parametrize("mutation", STATIC_MUTATIONS)
def test_table_passes_and_solve_budget_match_reference(ref_ctxs, mutation):
    """arena-layout, schedule-conflict and solve-budget give the
    reference's violations and info numbers, clean and under the
    mutations that target them."""
    rctx = ref_ctxs[mutation]
    tctx = build_context("pollutant-mlp", reduced=True, mutate=mutation,
                         device="cpu")
    for rpass, tpass in ((rpasses.arena_layout, tpasses.arena_layout),
                         (rpasses.schedule_conflict,
                          tpasses.schedule_conflict),
                         (rpasses.solve_budget, tpasses.solve_budget)):
        _same(rpass(rctx), tpass(tctx))
    if mutation is not None:
        bitten = get_mutation(mutation).expect_fail
        assert get_pass(bitten)(tctx)[0], bitten


def test_clean_reduced_mlp_audit_is_green():
    report = run_audit("pollutant-mlp", reduced=True, device="cpu")
    assert report.ok, report.render()
    names = [r.name for r in report.results]
    assert names == rregistry.list_passes() == list_passes()
    assert len(names) == 10
    # every recorded target is pinned, the kernels each one opaque call
    info = report.results[names.index("trace-budget")].info
    for t in ("train_step", "dmd_step", "dmd_step_gated", "record_update"):
        assert isinstance(info[f"{t}.pin"], dict), t
        assert info[f"{t}.launches"] == 1, t
        assert info[f"{t}.device_launches"] == {}, t     # twins on the CPU
    dinfo = report.results[names.index("donation-alias")].info
    assert dinfo["train_step.alias_count"] == 6
    assert dinfo["train_step.dmd_copies"] == 0


@pytest.mark.parametrize("name", [n for n in list_mutations()
                                  if not get_mutation(n).needs_mesh])
def test_mutation_fails_exactly_its_pass(name):
    """Each seeded violation flips exactly the pass the reference names
    for it, and nothing else."""
    want = ref_mutation(name).expect_fail
    assert get_mutation(name).expect_fail == want
    report = run_audit("pollutant-mlp", reduced=True, mutate=name,
                       device="cpu")
    failed = {r.name for r in report.results if not r.ok}
    assert failed == {want}, report.render()


def test_only_force_allgather_is_missing():
    """Every reference mutation is ported, beside the port's own
    force-gather-model; force-allgather and force-gather-model (the ones
    that need a mesh, tests/test_torch_distributed.py) refuse a
    one-device build, and a mesh build needs a process group."""
    assert set(list_mutations()) == set(ref_mutations()) | {
        "force-gather-model"}
    assert [n for n in list_mutations() if get_mutation(n).needs_mesh] == \
        ["force-allgather", "force-gather-model"]
    with pytest.raises(ValueError, match="needs --mesh"):
        build_context("pollutant-mlp", reduced=True,
                      mutate="force-gather-model", device="cpu")
    with pytest.raises(ValueError, match="needs --mesh"):
        build_context("pollutant-mlp", reduced=True, mutate="force-allgather",
                      device="cpu")
    with pytest.raises(RuntimeError, match="default process group"):
        build_context("pollutant-mlp", reduced=True, mesh_shape=(2, 4),
                      device="cpu")


def test_reduced_tinyllama_audit_green_with_serve():
    report = run_audit("tinyllama-1.1b", reduced=True, serve=True,
                       device="cpu")
    assert report.ok, report.render()
    by = {r.name: r for r in report.results}
    info = by["trace-budget"].info
    assert isinstance(info["train_step.pin"], dict)
    # K7 and K7b per layer and K1 per bucket, each one opaque call
    assert info["train_step.launches"] == 6
    sinfo = by["serve-compile"].info
    assert sinfo["steady_compiles"] == 0 and sinfo["dropped"] == 0
    assert sinfo["n_programs"] <= sinfo["max_programs"]
    assert sinfo["decode_cache_copies"] == 0
    assert by["solve-budget"].info["solve_budget_rows"] == \
        by["solve-budget"].info["dmd_step.eigh_rows"]


def test_bucket_scope_pins_and_solve_budget():
    """The reduced TinyLlama at scope "bucket": pinned under its own key,
    the jump's solve rows collapse to one per bucket, and the leaf-scope
    jump's target in the bucket-scope context bites."""
    model, acfg, batch = ttargets._build_model_and_config(
        "tinyllama-1.1b", True, "cpu")
    acfg = dataclasses.replace(
        acfg, dmd=dataclasses.replace(acfg.dmd, scope="bucket"))
    ctx = context_for("tinyllama-1.1b-reduced-bucket", model, acfg, batch,
                      device="cpu")
    vs, info = tpasses.trace_budget(ctx)
    assert vs == [], vs
    assert isinstance(info["train_step.pin"], dict)
    assert isinstance(info["dmd_step.pin"], dict)
    sv, sinfo = tpasses.solve_budget(ctx)
    assert sv == [], sv
    assert sinfo["solve_budget_rows"] == len(ctx.arena) == \
        sinfo["dmd_step.eigh_rows"]
    leaf = build_context("tinyllama-1.1b", reduced=True, device="cpu")
    bad = adhoc_context("tinyllama-1.1b-reduced-bucket", ctx.acfg,
                        {"dmd_step": leaf.targets["dmd_step"]},
                        plans=ctx.plans, arena=ctx.arena)
    bv, binfo = tpasses.solve_budget(bad)
    assert bv and binfo["dmd_step.eigh_rows"] > binfo["solve_budget_rows"]


def test_deep_mlp_train_step_is_pinned():
    """A 24-layer MLP (48 leaves in one bucket): the fused step makes ONE
    K1 call, not one per leaf, within its pin."""
    acfg = dataclasses.replace(
        get_config("pollutant-mlp"),
        dmd=DMDConfig(m=6, s=10, warmup_steps=2, cooldown_steps=1),
        optimizer=OptimizerConfig(name="adam", lr=1e-3),
        train=TrainConfig(global_batch=8, seq_len=1))
    gen = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn(8, 32, generator=gen),
             "y": torch.randn(8, 32, generator=gen)}
    ctx = context_for("deep-mlp-24x32", MLPModel([32] * 25), acfg, batch,
                      device="cpu")
    vs, info = tpasses.trace_budget(ctx)
    assert vs == [], vs
    assert info["train_step.pin"]["eqns"] == 600
    assert info["train_step.launches"] == 1


def test_kernel_call_records_as_one_opaque_op():
    """A kernel wrapper records as one op whatever its twin runs; the twin
    called directly records its own ops; a scalar read is a sync."""
    gen = torch.Generator().manual_seed(0)
    buf = torch.randn((4, 3, 128), generator=gen)
    seg = ka.Segments.from_block_sys(np.array([0, 0, 1, 1]), 2, "cpu")
    out, rec = ops_mod.record(ka.gram_row, buf, buf[:, 1, :], seg)
    assert [o.name for o in rec.ops] == ["kernel.gram_row"]
    assert rec.ops[0].outputs[0].shape == "f32[2,3]"
    assert rec.launches == {}
    torch.testing.assert_close(out, ka.gram_row_ref(buf, buf[:, 1, :],
                                                    seg.block_sys, 2))
    _, twin = ops_mod.record(ka.gram_row_ref, buf, buf[:, 1, :],
                             seg.block_sys, 2)
    assert twin.count > 1 and not twin.kernel_calls
    _, rec = ops_mod.record(lambda t: t.sum().item(), buf)
    assert [o.sync for o in rec.ops] == [False, True]


SNIPPETS = {
    "host-time": "import time\n\n\ndef f():\n    return time.perf_counter()\n",
    "host-sync": "import torch\n\n\ndef f(t):\n    torch.cuda.synchronize()\n"
                 "    return t.item()\n",
    "nonstatic-shape": "import torch\n\n\ndef f(t):\n"
                       "    return int(torch.sum(t))\n",
    "unused-import": "import os\n",
}


@pytest.mark.parametrize("rule", sorted(SNIPPETS))
def test_lint_bites_on_a_seeded_snippet(rule):
    src = SNIPPETS[rule]
    hot = lint_source(src, "repro_torch/core/seeded.py")
    assert hot and {f[2] for f in hot} == {rule}, hot
    cold = lint_source(src, "repro_torch/launch/seeded.py")
    assert [f[2] for f in cold] == (["unused-import"]
                                    if rule == "unused-import" else [])
    allowed = "\n".join(ln + f"  # lint: allow-{rule} (seeded)"
                        if ln.strip() else ln for ln in src.splitlines())
    assert lint_source(allowed, "repro_torch/core/seeded.py") == []
    if rule == "host-sync":      # the DMD solve's host step is sanctioned
        assert lint_source(src, "repro_torch/core/dmd.py") == []


def test_lint_port_is_clean():
    assert lint_paths([SRC / "repro_torch"]) == []


def test_cli_exit_code_and_json(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    clean = subprocess.run(
        [sys.executable, "-m", "repro_torch.audit", "--arch",
         "pollutant-mlp", "--reduced", "--device", "cpu", "--out",
         str(tmp_path)], capture_output=True, text=True, env=env,
        timeout=300)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    assert "CLEAN: 0 error(s)" in clean.stdout
    payload = json.loads(
        (tmp_path / "AUDIT_torch_pollutant-mlp-reduced.json").read_text())
    assert payload["ok"] is True
    assert [p["name"] for p in payload["passes"]] == list_passes()
    assert {"plans", "arena", "groups"} <= set(payload["tables"])
    assert payload["meta"]["config_key"] == "pollutant-mlp-reduced"
    rc = cli.main(["--arch", "pollutant-mlp", "--reduced", "--device", "cpu",
                   "--mutate", "force-pack", "--out", str(tmp_path / "m")])
    assert rc == 1
    mutated = json.loads((tmp_path / "m" /
                          "AUDIT_torch_pollutant-mlp-reduced.json")
                         .read_text())
    assert [p["name"] for p in mutated["passes"] if not p["ok"]] == \
        ["arena-residency"]
    with pytest.raises(ValueError, match="needs --mesh"):
        cli.main(["--arch", "pollutant-mlp", "--mutate", "force-allgather",
                  "--device", "cpu"])
