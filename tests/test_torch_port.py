"""The PyTorch port's scaffolding against the JAX reference: mirrored
configs, schedule arithmetic, param-tree paths, lane tiling, device routing
and import hygiene. Exact equality throughout (no floating point here)."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import base as jbase
from repro.core import schedule as jsched
from repro.distributed.sharding import normalize_path as j_normalize_path
from repro.kernels.ops import LANES as J_LANES, lane_block as j_lane_block
from repro_torch.configs import base as tbase
from repro_torch.core import paths as tpaths
from repro_torch.core import schedule as tsched
from repro_torch.kernels import device as tdev
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parent.parent


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            default = f.default
        elif f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        else:
            default = dataclasses.MISSING         # a required field
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["DMDConfig", "DMDControllerConfig",
                                  "OptimizerConfig", "MoEConfig",
                                  "SSMConfig", "ModelConfig",
                                  "ParallelConfig", "TrainConfig",
                                  "ShapeConfig", "ArchConfig"])
def test_config_fields_and_defaults_mirror_reference(name):
    _assert_mirrors(getattr(tbase, name), getattr(jbase, name), name)


def test_shapes_and_arch_list_mirror_reference():
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    assert [dataclasses.asdict(s) for s in tbase.STANDARD_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.STANDARD_SHAPES]
    assert tconfigs.list_archs() == jconfigs.list_archs()
    # every architecture of the reference builds, field for field its own
    for arch in jconfigs.list_archs() + ["pollutant-mlp"]:
        assert dataclasses.asdict(tconfigs.get_config(arch)) == \
            dataclasses.asdict(jconfigs.get_config(arch)), arch
    for s in jbase.STANDARD_SHAPES:
        assert dataclasses.asdict(tconfigs.shape_by_name(s.name)) == \
            dataclasses.asdict(jconfigs.shape_by_name(s.name))
    with pytest.raises(KeyError):
        tconfigs.shape_by_name("train_8k")


def _assert_mirrors(port_cls, ref_cls, where):
    """Same field names in the same order and equal defaults, nested
    config dataclasses compared field by field the same way."""
    port, ref = _fields(port_cls), _fields(ref_cls)
    assert [n for n, _ in port] == [n for n, _ in ref], where
    for (n, dp), (_, dr) in zip(port, ref):
        if dataclasses.is_dataclass(dp):
            _assert_mirrors(type(dp), type(dr), f"{where}.{n}")
        else:
            assert dp == dr, f"{where}.{n}"


def test_tinyllama_config_and_reduced_mirror_reference():
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config as t_get_config
    jc, tc = j_get_config("tinyllama-1.1b"), t_get_config("tinyllama-1.1b")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(n_layers=2, d_model=32, n_kv_heads=1),
               dict(dtype="float32")):
        assert dataclasses.asdict(tbase.reduced(tc.model, **kw)) == \
            dataclasses.asdict(jbase.reduced(jc.model, **kw))
    for cfg in (tc.model, tbase.ModelConfig(vocab_size=1000)):
        j = jbase.ModelConfig(**dataclasses.asdict(cfg) | {
            "moe": jbase.MoEConfig(), "ssm": jbase.SSMConfig()})
        assert (cfg.padded_vocab, cfg.q_dim, cfg.kv_dim) == \
            (j.padded_vocab, j.q_dim, j.kv_dim)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_configs_and_reduced_mirror_reference(arch):
    from repro.configs import get_config as j_get_config
    from repro_torch.configs import get_config as t_get_config
    jc, tc = j_get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    for kw in ({}, dict(n_layers=3, d_model=32, n_kv_heads=1),
               dict(dtype="float32")):
        assert dataclasses.asdict(tbase.reduced(tc.model, **kw)) == \
            dataclasses.asdict(jbase.reduced(jc.model, **kw))
    assert (tc.model.padded_vocab, tc.model.q_dim, tc.model.kv_dim) == \
        (jc.model.padded_vocab, jc.model.q_dim, jc.model.kv_dim)


def test_group_rule_mirrors_reference():
    assert _fields(tsched.DMDGroupRule) == _fields(jsched.DMDGroupRule)
    assert [f.name for f in dataclasses.fields(tsched.GroupSchedule)] == \
        [f.name for f in dataclasses.fields(jsched.GroupSchedule)]


def _both_cfgs(**kw):
    rules = kw.pop("rules", ())
    jcfg = jbase.DMDConfig(groups=tuple(jsched.DMDGroupRule(**r)
                                        for r in rules), **kw)
    tcfg = tbase.DMDConfig(groups=tuple(tsched.DMDGroupRule(**r)
                                        for r in rules), **kw)
    return jcfg, tcfg


@pytest.mark.parametrize("kw", [
    {},
    dict(m=6, s=24, warmup_steps=3, cooldown_steps=0),
    dict(cooldown_steps=0, rules=(dict(name="biases", max_ndim=1, m=6,
                                       phase=7, cooldown_steps=8, s=24,
                                       reset_opt=False),)),
    dict(param_filter="matrices_only", min_param_size=10,
         rules=(dict(path_regex="l1", m=5, anneal=0.5),
                dict(path_regex="l2", exclude=True))),
])
def test_schedule_matches_reference(kw):
    jcfg, tcfg = _both_cfgs(**kw)
    jg, tg = jsched.resolve_groups(jcfg), tsched.resolve_groups(tcfg)
    assert [dataclasses.asdict(g) for g in tg] == \
        [dataclasses.asdict(g) for g in jg]
    for step in range(0, 400, 7):
        np.testing.assert_array_equal(tsched.slots_array(tg, step),
                                      jsched.slots_array(jg, step))
        for a, b in zip(tg, jg):
            assert a.round_index(step) == b.round_index(step)
            assert a.relax_for_round(a.round_index(step)) == \
                b.relax_for_round(b.round_index(step))
    for path, ndim, size in [("/l0/w", 2, 240), ("/l1/b", 1, 40),
                             ("/l2/w", 2, 8000), ("/x", 1, 3), ("/y", 0, 0)]:
        assert tsched.group_for_leaf(tcfg, path, ndim, size) == \
            jsched.group_for_leaf(jcfg, path, ndim, size)


def test_paths_follow_jax_flattening_order():
    """Dict keys are visited SORTED (b before w), as JAX flattens them;
    registration order would give a different arena layout."""
    tree = {"l1": {"w": 1, "b": 2}, "l0": {"w": 3, "b": 4},
            "z": [5, {"k": 6}]}
    jflat = jax.tree_util.tree_flatten_with_path(tree)[0]
    jpaths = [j_normalize_path(jax.tree_util.keystr(kp)) for kp, _ in jflat]
    tpaths_ = tpaths.leaves_with_paths(tree)
    assert [p for p, _ in tpaths_] == jpaths
    assert [v for _, v in tpaths_] == [v for _, v in jflat]
    for ks in ["['a']['b']", "['seg0']['attn'].wq", "[3]['x']"]:
        assert tpaths.normalize_path(ks) == j_normalize_path(ks)
    doubled = tpaths.map_with_paths(lambda p, v: (p, 2 * v), tree)
    assert doubled["l0"]["b"] == ("/l0/b", 8)
    assert doubled["z"][1]["k"] == ("/z/1/k", 12)


def test_lane_block_matches_reference():
    assert tops.LANES == J_LANES
    for block_n in (64, 128, 500, 512, 2048):
        for n in (1, 7, 127, 128, 130, 333, 5200, 1_000_000):
            assert tops.lane_block(block_n, n) == j_lane_block(block_n, n)


def test_device_routing():
    cpu = torch.zeros(2)
    assert tdev.on_cuda(cpu, cpu) is False
    with pytest.raises(ValueError, match="devices"):
        tdev.on_cuda(cpu, torch.zeros(2, device="meta"))
    assert tdev.resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdev.resolve_device("cuda")


def test_tf32_is_off_after_import():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_port_imports_neither_jax_nor_reference():
    """Import the port and every submodule in a fresh interpreter: neither
    ``jax`` nor ``repro`` may end up in sys.modules."""
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "assert len(mods) >= 30, mods\n"
        "for m in ('configs.tinyllama_1_1b', 'models.layers', "
        "'models.attention', 'models.transformer', "
        "'kernels.flash_attention', 'serve.engine', 'serve.store', "
        "'launch.serve', 'launch.train', 'configs', "
        "'distributed', 'distributed.sharding', 'distributed.gradsync', "
        "'kernels.sharded', 'launch.mesh', 'launch.inputs'):\n"
        "    assert 'repro_torch.' + m in mods, m\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_neither_jax_nor_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    assert any(n.startswith("repro_torch") for n in names)
    for n in names:
        top = n.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), n


def test_default_schedule_counts_in_300_steps():
    """The default config (warmup 100, cooldown 10, m 14) records on 112 of
    300 steps and jumps 8 times, at 123, 147, ..., 291, in both packages
    (the launch counts the chip run asserts)."""
    tg = tsched.resolve_groups(tbase.DMDConfig())
    jg = jsched.resolve_groups(jbase.DMDConfig())
    assert sum(tg[0].should_record(t) for t in range(300)) == 112
    jumps = [t for t in range(300) if tg[0].should_apply(t)]
    assert jumps == list(range(123, 300, 24)) and len(jumps) == 8
    assert int(jnp.asarray(jsched.slots_for_step(jg, 123))[0]) == 13


def test_ptxas_report_is_parsed_per_kernel():
    """The build keeps ptxas's -v report; chip_smoke.py reads registers and
    spills per kernel from it (spills of K7's Hopper design fail it)."""
    from repro_torch.kernels._build import kernel_resources

    log = """== flash.cu
ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 512 bytes smem
"""
    assert kernel_resources(log) == {
        "_Z3fooPf": {"smem": 0, "stack": 0, "spill_stores": 0,
                     "spill_loads": 0, "registers": 168},
        "_Z3barPf": {"smem": 512, "stack": 8, "spill_stores": 4,
                     "spill_loads": 12, "registers": 40}}


# ptxas's mangled names -> chip_smoke.py's kernel name and MMAX (K3's and
# K6's m <= 16 instantiations must not spill; those for m 17..32 may)
@pytest.mark.parametrize("mangled,name,mmax", [
    ("_ZN40_GLOBAL__N__0956573d_8_arena_cu_d090ae0612arena_gram_kIfLi16ELb1"
     "EEEvPKT_PKiS5_PfPjS6_iiiii", "arena_gram_k<float,16,vec=1>", 16),
    ("_ZN39_GLOBAL__N__13eb64e5_7_flat_cu_a4e5b7ab9gram_flatI13__nv_bfloat16"
     "Li32ELb0EEEvPKT_xxPfPjS5_iii", "gram_flat<bf16,32,vec=0>", 32),
    ("_ZN39_GLOBAL__N__13eb64e5_7_flat_cu_a4e5b7ab8row_partIfLi8ELb1EEEv",
     "row_part<float,8,vec=1>", 8),
    ("_Z11flash_wgmmaILi128EEvv", "flash_wgmma<128>", None),
    ("_ZN6hopper11flash_wgmmaILi64EN12_GLOBAL__N_110ProblemLseEEEv14CUtensor"
     "Map_stS3_S3_P13__nv_bfloat16T0_", "flash_wgmma<64,lse>", None),
    ("_ZN6hopper11flash_wgmmaILi128EN12_GLOBAL__N_110ProblemOffEEEv14CUtenso"
     "rMap_stS3_S3_P13__nv_bfloat16T0_", "flash_wgmma<128,off>", None),
    ("_ZN47_GLOBAL__N__d29a3f0f_12_flash_bwd_cu_f0d3f5b46hopper14bwd_dkdv_"
     "wgmmaILi64EEEv14CUtensorMap_stS2_S2_S2_P13__nv_bfloat16S4_NS_3BwdEi",
     "bwd_dkdv_wgmma<64>", None),
    ("_ZN47_GLOBAL__N__d29a3f0f_12_flash_bwd_cu_f0d3f5b46hopper12bwd_dq_"
     "wgmmaILi128EEEv14CUtensorMap_stS2_S2_S2_P13__nv_bfloat16NS_3BwdEi",
     "bwd_dq_wgmma<128>", None),
    ("_ZN47_GLOBAL__N__d29a3f0f_12_flash_bwd_cu_f0d3f5b46hopper14bwd_rows_"
     "wgmmaILi64EEEvPK13__nv_bfloat16S4_NS_3BwdEi", "bwd_rows_wgmma<64>",
     None),
    ("_Z3fooPf", None, None),
])
def test_chip_smoke_names_ptxas_kernels(mangled, name, mmax):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert chip_smoke._kernel_name(mangled) == (name, mmax)


def test_library_path_hashes_every_file_under_csrc(tmp_path, monkeypatch):
    """The built library is named by a hash of every file under csrc/, the
    headers the sources include too: an edited header never loads a stale
    library."""
    from repro_torch.kernels import _build

    for path in _build._inputs():
        shutil.copy(path, tmp_path / path.name)
    assert {"arena.cu", "flat.cu", "flash.cu", "flash_bwd.cu", "flash.cuh",
            "lanes.cuh"} <= {
        p.name for p in tmp_path.iterdir()}
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    base = _build.library_path()
    for path in sorted(tmp_path.iterdir()):
        text = path.read_bytes()
        path.write_bytes(text + b"\n// edited\n")
        assert _build.library_path() != base, path.name
        path.write_bytes(text)
        assert _build.library_path() == base
    (tmp_path / "more.cuh").write_text("// a new header\n")
    assert _build.library_path() != base
    assert [p.name for p in _build.sources()] == [
        "arena.cu", "flash.cu", "flash_bwd.cu", "flat.cu"]   # not headers
