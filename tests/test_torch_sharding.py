"""The mesh's tables and block math in one process, against the reference.

The reference's spec, plan and arena tables read a mesh only through its
``axis_names`` and ``devices.shape``, so both packages build them here
from the reference tests' ``_FakeMesh`` (tests/test_arena.py); no process
group is made. Exact equality throughout: the tables are integers and
strings, and the block slicing, head padding and stack splitting move
numbers without arithmetic.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import DMDConfig as JDMD
from repro.core import arena as rarena
from repro.core import leafplan as rleafplan
from repro.core.accelerator import DMDAccelerator as RAcc
from repro.distributed import sharding as rsharding
from repro.launch import inputs as rinputs
from repro.models import attention as rattention
from repro.train.step import resolve_grad_accum as r_resolve_grad_accum
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.configs.base import DMDConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import arena as tarena
from repro_torch.core import leafplan as tleafplan
from repro_torch.core.accelerator import DMDAccelerator as TAcc
from repro_torch.core.paths import leaves_with_paths
from repro_torch.distributed import sharding as tsharding
from repro_torch.launch import inputs as tinputs
from repro_torch.models import attention as tattention
from repro_torch.models.transformer import LanguageModel, init_params
from repro_torch.train.step import resolve_grad_accum

MESHES = {"2x2": ((2, 2), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class _FakeMesh:
    """The reference tests' structural mesh: axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.empty(shape)


class _RankMesh(_FakeMesh):
    """A structural mesh seen from one rank (``local_shard`` reads only
    the sizes and the rank's coordinates)."""

    def __init__(self, shape, names, rank):
        super().__init__(shape, names)
        self.sizes = dict(zip(names, shape))
        self.coords = dict(zip(names, (int(c) for c in
                                       np.unravel_index(rank, shape))))

    def axis_size(self, axes):
        return int(np.prod([self.sizes.get(a, 1) for a in axes]))

    def axis_index(self, axes):
        idx = 0
        for a in axes:
            idx = idx * self.sizes.get(a, 1) + self.coords.get(a, 0)
        return idx


def _mesh(name):
    return _FakeMesh(*MESHES[name])


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_spec_for_path_matches_reference(arch, mesh):
    """Every param of every reduced architecture gets the reference's
    partition spec, printed alike, on (2, 2), (4, 2) and (2, 2, 2)."""
    params = init_params(reduced(get_config(arch).model), device="meta")
    fake = _mesh(mesh)
    n = 0
    for path, x in leaves_with_paths(params):
        shape = tuple(x.shape)
        want = rsharding.spec_for_path(path, x.dim(), fake, shape)
        got = tsharding.spec_for_path(path, x.dim(), fake, shape)
        assert str(got) == str(want), (path, shape)
        assert tuple(got) == tuple(want), path
        n += 1
    assert n > 5


def _builds(case: str, mesh):
    """(reference acc, port acc, reference params, port params): the
    audit's reduced TinyLlama (lane-sharded buckets), or the reference
    test's system-sharded pair."""
    if case == "sys":
        shapes = {"stacked": (4, 64, 128), "w": (64, 128)}
        rparams = {k: jnp.ones(s) for k, s in shapes.items()}
        sd = {"stacked": 1, "w": 0}
        cfg = dict(m=4, s=4)
        racc = RAcc(JDMD(**cfg), mesh=mesh, stack_dims=sd)
        tacc = TAcc(DMDConfig(**cfg), device="cpu", mesh=mesh,
                    stack_dims={"/stacked": 1, "/w": 0})
        tparams = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         rparams),
                                  device="cpu")
        return racc, tacc, rparams, tparams
    from repro.audit import targets as rtargets
    from repro_torch.audit import targets as ttargets
    from repro_torch.train.step import model_stack_dims
    rmodel, racfg, _ = rtargets._build_model_and_config(
        "tinyllama-1.1b", True)
    tmodel, tacfg, _ = ttargets._build_model_and_config(
        "tinyllama-1.1b", True, "cpu")
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, rparams),
                              device="cpu")
    racc = RAcc(racfg.dmd, mesh=mesh, stack_dims=rmodel.param_stack_dims())
    tacc = TAcc(tacfg.dmd, stack_dims=model_stack_dims(tmodel),
                device="cpu", mesh=mesh)
    return racc, tacc, rparams, tparams


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", ["lane", "sys"])
def test_plan_and_layout_tables_match_reference(case, mesh):
    """``plan_records`` / ``plan_summary`` and the arena ``layout_table``
    (every key: the lane and system axes, their factors, the local and
    global counts, each segment's local shape) equal the reference's
    under a mesh, for lane-sharded buckets and a system-sharded one (the
    reference test's override), and so do the block tables."""
    fake = _mesh(mesh)
    if case == "sys":
        rsharding.set_rule_overrides([(r"stacked", ("fsdp", None, "tp"))])
        tsharding.set_rule_overrides([(r"stacked", ("fsdp", None, "tp"))])
    try:
        racc, tacc, rparams, tparams = _builds(case, fake)
        rplans, tplans = racc.plans_for(rparams), tacc.plans_for(tparams)
        assert tleafplan.plan_records(tplans) == \
            rleafplan.plan_records(rplans)
        assert tleafplan.plan_summary(tplans) == \
            rleafplan.plan_summary(rplans)
        rtable, ttable = racc.arena_for(rparams), tacc.arena_for(tparams)
        for scope in ("leaf", "bucket"):
            assert tarena.layout_table(ttable, scope) == \
                rarena.layout_table(rtable, scope)
        for key in ttable:
            np.testing.assert_array_equal(ttable[key].block_sys(),
                                          rtable[key].block_sys())
            assert str(ttable[key].buffer_spec()) == \
                str(rtable[key].buffer_spec())
            assert str(ttable[key].gram_spec()) == \
                str(rtable[key].gram_spec())
            assert str(ttable[key].lane_spec()) == \
                str(rtable[key].lane_spec())
        if case == "sys":
            sys_b = [b for b in ttable.values() if b.sys_axes]
            assert sys_b and not sys_b[0].bucket_scoped("bucket")
        else:
            assert any(b.lane_axes for b in ttable.values())
        for p in tleafplan.plan_entries(tplans):
            assert tarena.arena_eligible(p, tacc.cfg, fake) == \
                rarena.arena_eligible(
                    {q.path: q for q in rleafplan.plan_entries(rplans)}
                    [p.path], racc.cfg, fake)
    finally:
        rsharding.set_rule_overrides(None)
        tsharding.set_rule_overrides(None)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_grad_accum_match_reference(mesh):
    """The batch specs of a gate batch and the accumulation factor under
    a mesh are the reference's."""
    fake = _mesh(mesh)
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((8, 16), np.int32),
             "odd": np.zeros((3, 4), np.float32)}
    want = rinputs.gate_batch_specs(batch, fake)
    got = tinputs.gate_batch_specs({k: torch.from_numpy(v)
                                    for k, v in batch.items()}, fake)
    for k in batch:
        assert str(got[k]) == str(want[k]), k
    assert tinputs.batch_axes(fake) == rinputs.batch_axes(fake)
    acfg = get_config("tinyllama-1.1b")
    racfg = j_get_config("tinyllama-1.1b")
    for ga in (1, 2, 3, 4, 8):
        for gb in (8, 16, 64, 256):
            t = dataclasses.replace(acfg, parallel=dataclasses.replace(
                acfg.parallel, grad_accum=ga))
            r = dataclasses.replace(racfg, parallel=dataclasses.replace(
                racfg.parallel, grad_accum=ga))
            assert resolve_grad_accum(t, fake, gb) == \
                r_resolve_grad_accum(r, fake, gb), (ga, gb)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_local_shards_tile_the_full_tensor(mesh):
    """Each rank's block under a spec is its slice of the full tensor, and
    the blocks of all ranks tile it (a tuple entry splits its dim with the
    first axis major, as a NamedSharding does)."""
    shape, names = MESHES[mesh]
    full = torch.arange(8 * 4 * 16, dtype=torch.float32).reshape(8, 4, 16)
    specs = [tsharding.Spec(None, "data", "model"),
             tsharding.Spec(tinputs.batch_axes(_FakeMesh(shape, names))),
             tsharding.Spec(("data", "model"), None, None),
             tsharding.Spec()]
    for spec in specs:
        seen = torch.zeros_like(full)
        ranks = int(np.prod(shape))
        for r in range(ranks):
            m = _RankMesh(shape, names, r)
            block = tsharding.local_shard(full, spec, m)
            assert block.shape == tsharding.local_shape(full.shape, spec, m)
            idx = []
            for dim, e in enumerate((tuple(spec) + (None,) * 3)[:3]):
                axes = tsharding.entry_axes(e)
                n = m.axis_size(axes)
                c = full.shape[dim] // n
                i = m.axis_index(axes)
                idx.append(slice(i * c, (i + 1) * c))
            assert torch.equal(block, full[tuple(idx)]), (spec, r)
            seen[tuple(idx)] += 1
        replicas = ranks // int(np.prod(
            [m.axis_size(tsharding.entry_axes(e)) for e in spec] or [1]))
        assert torch.equal(seen, torch.full_like(full, replicas)), spec


def test_specs_print_as_partition_specs():
    P = jax.sharding.PartitionSpec
    for entries in [(), (None,), ("data",), (None, "data", "model"),
                    (("pod", "data"), None), (("data", "model"),)]:
        assert str(tsharding.Spec(*entries)) == str(P(*entries)), entries
    assert tsharding.logical_axis_rules() == rsharding.logical_axis_rules()
    x = torch.ones(3)
    assert tsharding.constrain(x, "batch", None) is x


@pytest.mark.parametrize("groups_rep", [(1, 6, 8), (2, 3, 4), (4, 1, 3)])
def test_pad_heads_matches_reference(groups_rep):
    K, rep, _ = groups_rep
    x = np.random.default_rng(0).standard_normal(
        (2, 5, K * rep, 16)).astype(np.float32)
    want = rattention.pad_heads(jnp.asarray(x), groups_rep)
    got = tattention.pad_heads(torch.from_numpy(x), groups_rep)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("heads,kv", [(6, 6), (6, 2), (12, 4)])
def test_attend_with_padded_heads_equals_attend(heads, kv):
    """``pad_heads_to`` pads MHA's q, k and v and GQA's q heads per group;
    the real heads' outputs are those of the unpadded attention, bit for
    bit, and a model built with it gives the same loss."""
    mc = reduced(get_config("tinyllama-1.1b").model, n_layers=1,
                 d_model=48, d_ff=64, vocab_size=64, n_heads=heads,
                 n_kv_heads=kv, head_dim=16, dtype="float32")
    model = LanguageModel(mc, chunk_k=16, device="cpu")
    padded = LanguageModel(mc, chunk_k=16, device="cpu", pad_heads_to=8)
    params = model.init(torch.Generator().manual_seed(0))
    x = torch.randn((2, 20, 48), generator=torch.Generator().manual_seed(1))
    p = {k: v[0] for k, v in params["seg0"]["attn"].items()}
    pos = torch.arange(20)[None]
    want, _ = tattention.attend(x, p, mc, positions=pos)
    got, _ = tattention.attend(x, p, mc, positions=pos, pad_heads_to=8)
    assert torch.equal(got, want)
    toks = torch.randint(1, 64, (2, 21),
                         generator=torch.Generator().manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    assert torch.equal(padded.loss(params, batch)[0],
                       model.loss(params, batch)[0])
