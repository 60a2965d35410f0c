"""The port's packed arenas and DMDAccelerator against the reference's.

Layouts must be identical. Accelerator cycles run on integer-valued
trajectories, where every fp32 sum is exact in any order: buffers and
Grams must be bit-exact. Post-jump params come from two different
eigensolvers, so they are held to |diff| <= 1e-3 * max(1, |w|) and then
both runs continue from the reference's rounded params (the reference's
own post-jump ``round``), which keeps the next window integer-valued in
both packages."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import DMDConfig as JCfg
from repro.core import DMDAccelerator as JAcc
from repro.core import arena as jarena
from repro.core.schedule import DMDGroupRule as JRule
from repro_torch.configs.base import DMDConfig as TCfg
from repro_torch.configs.pollutant_mlp import PAPER_SIZES
from repro_torch.core import arena as tarena
from repro_torch.core.accelerator import DMDAccelerator as TAcc
from repro_torch.core.schedule import DMDGroupRule as TRule
from repro_torch.kernels import arena as tka
from repro_torch.kernels import device as tdevice

PORT_LAYOUT_KEYS = ("key", "group", "m", "scope", "n_solve", "block_n",
                    "n_sys", "n_lanes")
PORT_SEG_KEYS = ("path", "sys_start", "lane_start", "n_sys", "flat_local",
                 "seg_lanes", "shape", "stack_dims", "param_dtype")


def _mlp_shapes(sizes):
    return {f"l{i}": {"w": (a, b), "b": (b,)}
            for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:]))}


def _both_params(shapes, np_dtype=np.float32, fill=None):
    flat = {}
    for layer, d in shapes.items():
        flat[layer] = {k: (np.zeros(s, np.float32) if fill is None
                           else fill(s)).astype(np_dtype)
                       for k, s in d.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, flat)
    tp = {layer: {k: torch.tensor(np.asarray(v, np.float32)).to(
        torch.bfloat16 if np_dtype == jnp.bfloat16 else torch.float32)
        for k, v in d.items()} for layer, d in flat.items()}
    return jp, tp


def _both_cfgs(rules=(), **kw):
    return (JCfg(groups=tuple(JRule(**r) for r in rules), **kw),
            TCfg(groups=tuple(TRule(**r) for r in rules), **kw))


def _project(rows):
    return [{**{k: r[k] for k in PORT_LAYOUT_KEYS},
             "segments": [{k: s[k] for k in PORT_SEG_KEYS}
                          for s in r["segments"]]} for r in rows]


@pytest.mark.parametrize("setup", [
    dict(sizes=PAPER_SIZES, cfg={}),
    dict(sizes=(6, 16, 40, 130), cfg=dict(arena_block_n=128)),
    dict(sizes=(6, 16, 40, 130), cfg=dict(rules=(dict(
        name="biases", max_ndim=1, m=6, phase=7, cooldown_steps=8, s=24),))),
    dict(sizes=(6, 16, 40, 130), cfg=dict(min_param_size=50),
         dtype=jnp.bfloat16),
])
def test_layout_table_matches_reference(setup):
    jp, tp = _both_params(_mlp_shapes(setup["sizes"]),
                          setup.get("dtype", np.float32))
    jcfg, tcfg = _both_cfgs(**setup["cfg"])
    jtable = JAcc(jcfg).arena_for(jp)
    ttable = TAcc(tcfg, device="cpu").arena_for(tp)
    want = _project(jarena.layout_table(jtable))
    got = tarena.layout_table(ttable)
    assert got == want
    for key in ttable:
        np.testing.assert_array_equal(ttable[key].block_sys(),
                                      jtable[key].block_sys())


def test_paper_bucket_layout():
    """The paper MLP packs into one fp32 bucket of 5633 blocks of 512
    lanes: (5633, 14, 512) fp32, 161.5 MB, the shape the chip run uses."""
    _, tp = _both_params(_mlp_shapes(PAPER_SIZES))
    acc = TAcc(TCfg(), device="cpu")
    (b,) = acc.arena_for(tp).values()
    assert (b.key, b.block_n, b.n_blocks, b.n_sys, b.n_lanes) == \
        ("g0-float32", 512, 5633, 8, 2_884_096)
    assert [s.path for s in b.segments] == [
        "/l0/b", "/l0/w", "/l1/b", "/l1/w", "/l2/b", "/l2/w", "/l3/b",
        "/l3/w"]
    assert [s.seg_lanes // 512 for s in b.segments] == \
        [1, 1, 1, 16, 2, 391, 6, 5215]
    assert tarena.arena_paths(acc.arena_for(tp)) == frozenset(
        s.path for s in b.segments)
    seg = b.tables_on(torch.device("cpu"))
    assert seg is b.tables_on(torch.device("cpu"))        # built once
    assert seg.sys_off.tolist()[-1] == 5633


def _cycles(jcfg, tcfg, sizes, steps, seed):
    """Lockstep record / update_grams / jump through both accelerators on
    integer trajectories; returns the number of jumps taken."""
    rng = np.random.default_rng(seed)
    shapes = _mlp_shapes(sizes)
    jp, tp = _both_params(shapes, fill=lambda s: rng.integers(-8, 9, s))
    deltas = {layer: {k: rng.integers(-2, 3, s).astype(np.float32)
                      for k, s in d.items()} for layer, d in shapes.items()}
    jacc, tacc = JAcc(jcfg), TAcc(tcfg, device="cpu")
    jb = jacc.init(jp)
    jg = jacc.init_grams(jb)
    tb = tacc.init(tp)
    tg = tacc.init_grams(tb)
    jumps = 0
    for t in range(steps):
        jp = jax.tree_util.tree_map(lambda x, d: x + d, jp, deltas)
        tp = {lk: {k: v + torch.tensor(deltas[lk][k]) for k, v in d.items()}
              for lk, d in tp.items()}
        if jacc.should_record(t):
            jb, jg = jacc.record(jb, jp, jacc.slots(t), jg)
            tb, tg = tacc.record(tb, tp, tacc.slots(t), tg)
        for key in tb["__arena__"]:
            np.testing.assert_array_equal(
                tb["__arena__"][key].float().numpy(),
                np.asarray(jb["__arena__"][key].astype(jnp.float32)))
            if tg is not None:
                np.testing.assert_array_equal(
                    tg["__arena__"][key].numpy(),
                    np.asarray(jg["__arena__"][key]))
        if jacc.should_apply(t):
            assert tacc.should_apply(t)
            jcopy = jax.tree_util.tree_map(lambda x: x.copy(), jp)
            jp, _ = jacc.apply(jcopy, jb, grams=jg, step=t)
            tp, stats = tacc.apply(tp, tb, grams=tg, step=t)
            assert torch.isfinite(stats["mean_rank"])
            for lk, d in tp.items():
                for k, v in d.items():
                    want = np.asarray(jp[lk][k], np.float32)
                    np.testing.assert_allclose(
                        v.float().numpy(), want, rtol=0,
                        atol=1e-3 * max(1.0, np.abs(want).max()))
            jp = jax.tree_util.tree_map(jnp.round, jp)
            tp = {lk: {k: torch.tensor(np.asarray(jp[lk][k], np.float32))
                       for k in d} for lk, d in tp.items()}
            jumps += 1
    return jumps


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(streaming_gram=False),
    dict(anchor="none", trust_region=0.0),
    dict(arena_block_n=128, rules=(dict(name="vecs", max_ndim=1, m=3,
                                        phase=1),)),
    dict(snapshot_dtype="bfloat16"),
])
def test_accelerator_cycles_match_reference(cfg):
    base = dict(m=4, s=5, warmup_steps=1, cooldown_steps=1, tol=1e-3)
    base.update(cfg)
    jcfg, tcfg = _both_cfgs(**base)
    jumps = _cycles(jcfg, tcfg, (6, 16, 40, 130), 14, seed=7)
    assert jumps >= 2


def test_accelerator_legacy_apply_and_schedule_views():
    jcfg, tcfg = _both_cfgs(m=4, s=5, warmup_steps=0, cooldown_steps=0,
                            anneal=0.5)
    acc = TAcc(tcfg, device="cpu")
    jacc = JAcc(jcfg)
    for step in range(20):
        np.testing.assert_array_equal(acc.relax_vector(step),
                                      jacc.relax_vector(step))
        assert acc.apply_groups(step) == jacc.apply_groups(step)
        assert acc.round_index(step) == jacc.round_index(step)
    _, tp = _both_params(_mlp_shapes((6, 8, 3)),
                         fill=lambda s: np.ones(s))
    bufs = acc.init(tp)
    for t in range(4):
        bufs, _ = acc.record(bufs, tp, t)
    new, _ = acc.apply(tp, bufs, 2)            # legacy round-index idiom
    assert set(new) == set(tp)
    assert acc.reset_groups() == (0,)
    assert "g0-float32" in acc.plan_table()


def test_unported_routes_raise():
    """Bucket scope and eig mode are not ported; the per-leaf route is, so
    `arena=False` and a forced `dot_general` route give the plain per-leaf
    buffer tree instead of raising."""
    _, tp = _both_params(_mlp_shapes((6, 8, 3)))
    for kw in (dict(arena=False), dict(kernel_route="dot_general")):
        bufs = TAcc(TCfg(**kw), device="cpu").init(tp)
        assert "__arena__" not in bufs
        assert bufs["l0"]["w"].shape == (14, 6, 8)
    with pytest.raises(NotImplementedError, match="bucket"):
        TAcc(TCfg(scope="bucket"), device="cpu")
    with pytest.raises(NotImplementedError, match="eig"):
        TAcc(TCfg(mode="eig"), device="cpu")
    assert TAcc(TCfg(enabled=False), device="cpu").init(tp) is None


def test_streaming_gram_equals_recompute_at_window_end():
    """DESIGN.md §2.2: at the window-complete point (slot m-1 just written)
    the carried streaming Gram equals the full recompute of the buffer
    (rtol 1e-5, atol 1e-6: fp32 summation order)."""
    rng = np.random.default_rng(11)
    _, tp = _both_params(_mlp_shapes((6, 16, 40, 130)),
                         fill=lambda s: rng.normal(size=s))
    acc = TAcc(TCfg(m=4, s=5, warmup_steps=0, cooldown_steps=0),
               device="cpu")
    bufs = acc.init(tp)
    grams = acc.init_grams(bufs)
    for t in range(8):
        tp = {lk: {k: v + 0.01 * (t + 1) * torch.randn(
            v.shape, generator=torch.Generator().manual_seed(t))
            for k, v in d.items()} for lk, d in tp.items()}
        bufs, grams = acc.record(bufs, tp, acc.slots(t), grams)
    assert acc.should_apply(7)          # second window complete
    assert bufs["leaf"] == {"l0": {"w": None, "b": None},
                            "l1": {"w": None, "b": None},
                            "l2": {"w": None, "b": None}}
    for key, b in acc.arena_for(tp).items():
        full = tka.gram(bufs["__arena__"][key],
                        b.tables_on(torch.device("cpu")), anchor_first=True)
        np.testing.assert_allclose(grams["__arena__"][key].numpy(),
                                   full.numpy(), rtol=1e-5, atol=1e-6)


def test_plans_cache_and_dtype_names():
    jp, tp = _both_params(_mlp_shapes((6, 8, 3)))
    acc = TAcc(TCfg(), device="cpu")
    plans = acc.plans_for(tp)
    assert acc.plans_for(tp) is plans
    assert acc.plans_for({**tp, "l9": {"b": torch.zeros(3)}}) is not plans
    jplans = JAcc(JCfg()).plans_for(jp)
    jflat = [p for p in jax.tree_util.tree_leaves(
        jplans, is_leaf=lambda x: x is None or hasattr(x, "route"))]
    from repro_torch.core.leafplan import plan_entries
    got = [(p.path, p.shape, p.dtype, p.route, p.block_n, p.group)
           for p in plan_entries(acc.plans_for(tp))]
    want = [(p.path, p.shape, p.dtype, p.route, p.block_n, p.group)
            for p in jflat]
    assert got == want
    assert dataclasses.is_dataclass(plans["l0"]["w"])


# K1's per-call choices on an (nb, m, bn) arena and its (nb, bn) query:
# (m, bn, dtype, offset in elements) -> 16-byte loads. bn is a multiple of
# 128 lanes on every arena the port builds; the others show the rule.
@pytest.mark.parametrize("m,bn,dtype,offset,want", [
    (14, 512, torch.float32, 0, True),              # the paper arena
    (14, 512, torch.bfloat16, 0, True),
    (3, 128, torch.bfloat16, 0, True),
    (17, 384, torch.float32, 0, True),
    (14, 512, torch.float32, 1, False),             # 4 bytes off
    (14, 512, torch.float32, 4, True),              # 16 bytes off
    (14, 100, torch.float32, 0, True),              # whole 4-lane units
    (14, 100, torch.bfloat16, 0, False),            # not whole 8-lane units
    (14, 101, torch.float32, 0, False),
])
def test_arena_gram_row_load_width_choice(m, bn, dtype, offset, want):
    nb = 7
    buf = torch.zeros(offset + nb * m * bn, dtype=dtype)[offset:].view(
        nb, m, bn)
    assert tdevice.vector_lanes(buf, buf[:, m - 1, :]) is want
    if want:                    # a query 4 bytes off, or rows bn + 1 apart
        q = torch.zeros(nb * bn + 2, dtype=dtype)[2:].view(nb, bn)
        assert tdevice.vector_lanes(buf, q) is False
        q = torch.zeros((nb, bn + 1), dtype=dtype)[:, :bn]
        assert tdevice.vector_lanes(buf, q) is False


def test_arena_gram_row_finds_the_query_slot():
    buf = torch.zeros((5, 14, 128))
    for j in (0, 6, 13):
        assert tdevice.query_slot(buf, buf[:, j, :], axis=1) == j
    assert tdevice.query_slot(buf, buf[:, 6, :].clone(), axis=1) == -1
    assert tdevice.query_slot(buf, torch.zeros((5, 128)), axis=1) == -1
    # slot 6's start, but rows 128 lanes apart instead of a block apart
    flat = buf.view(-1)[6 * 128:6 * 128 + 5 * 128].view(5, 128)
    assert tdevice.query_slot(buf, flat, axis=1) == -1
    one = torch.zeros((1, 4, 128))                  # one block: no row stride
    assert tdevice.query_slot(one, one[:, 3, :], axis=1) == 3


def test_arena_gram_row_grid_is_one_wave_over_blocks():
    assert tka.grid_ctas(5633, 14, 132) == tka.CTAS_PER_SM * 132
    assert tka.grid_ctas(5633, 16, 132) == tka.CTAS_PER_SM * 132
    assert tka.grid_ctas(5633, 17, 132) == 132      # one CTA's registers
    assert tka.grid_ctas(3, 14, 132) == 3               # a CTA per block
    assert tka.grid_ctas(1, 32, 132) == 1
