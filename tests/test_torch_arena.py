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
                    "n_sys", "n_sys_global", "n_lanes_local", "n_lanes",
                    "lane_axes", "shard_factor", "sys_axes", "sys_factor")
PORT_SEG_KEYS = ("path", "sys_start", "lane_start", "n_sys", "flat_local",
                 "seg_lanes", "shape", "local_shape", "stack_dims",
                 "param_dtype")


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
    dict(scope="bucket"),
    dict(scope="bucket", streaming_gram=False),
    dict(scope="bucket", arena_block_n=128, rules=(dict(
        name="vecs", max_ndim=1, m=3, phase=1),)),
    dict(mode="eig"),
    dict(mode="eig", clamp_eigs=True, scope="bucket"),
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
    """Every route of the reference is ported: `arena=False` and a forced
    `dot_general` route give the plain per-leaf buffer tree; bucket scope
    carries one (1, m, m) Gram per bucket; eig mode builds; an unknown
    scope raises ValueError, as in the reference."""
    _, tp = _both_params(_mlp_shapes((6, 8, 3)))
    for kw in (dict(arena=False), dict(kernel_route="dot_general")):
        bufs = TAcc(TCfg(**kw), device="cpu").init(tp)
        assert "__arena__" not in bufs
        assert bufs["l0"]["w"].shape == (14, 6, 8)
    acc = TAcc(TCfg(scope="bucket"), device="cpu")
    grams = acc.init_grams(acc.init(tp))
    assert [tuple(g.shape) for g in grams["__arena__"].values()] == \
        [(1, 14, 14)]
    assert TAcc(TCfg(mode="eig"), device="cpu").init(tp) is not None
    bad = TAcc(TCfg(scope="global"), device="cpu")
    with pytest.raises(ValueError, match="scope"):
        bad.init_grams(bad.init(tp))
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


# K3's grid and scratch (arena.gram_grid) on a card of 132 SMs: K1's
# contiguous block ranges at GRAM_CTAS_PER_SM CTAs per SM, one partial
# triangle (m(m+1)/2 floats) per (CTA, system) pair, row c + s
@pytest.mark.parametrize("nb,m,n_sys,ctas", [
    (5633, 14, 8, 132),         # the paper arena
    (5633, 8, 8, 132),
    (5633, 17, 8, 132),
    (1000, 14, 1, 132),         # an all-zeros table: one system, every CTA
    (3, 14, 2, 3),              # a CTA per block
    (1, 32, 1, 1),
])
def test_arena_gram_grid_is_one_wave_over_blocks(nb, m, n_sys, ctas):
    assert tka.GRAM_CTAS_PER_SM == 1
    assert tka.gram_grid(nb, m, n_sys, 132) == \
        (ctas, (ctas + n_sys) * m * (m + 1) // 2)


# K3's load width: 16 bytes where the buffer alone allows (K1's rule
# without the query): (m, bn, dtype, offset in elements) -> 16-byte loads
@pytest.mark.parametrize("m,bn,dtype,offset,want", [
    (14, 512, torch.float32, 0, True),              # the paper arena
    (14, 512, torch.bfloat16, 0, True),
    (32, 640, torch.bfloat16, 0, True),
    (14, 512, torch.float32, 1, False),             # 4 bytes off
    (14, 100, torch.bfloat16, 0, False),            # not whole 8-lane units
    (1, 128, torch.float32, 0, True),
])
def test_arena_gram_load_width_choice(m, bn, dtype, offset, want):
    buf = torch.empty(offset + 5633 * m * bn, dtype=dtype,
                      device="meta")[offset:].view(5633, m, bn)
    assert tdevice.vector_lanes(buf) is want


# -- bucket scope (DESIGN.md §9), mirroring tests/test_arena.py:446-580 -------

def _bcfg(**kw):
    kw = {**dict(m=4, s=5, warmup_steps=0, cooldown_steps=0, tol=1e-6), **kw}
    return JCfg(**kw), TCfg(**kw)


def _int_flat(rng, sizes):
    return {k: rng.integers(-8, 9, size=s).astype(np.float32)
            for k, s in sizes.items()}


def _run_both(jcfg, tcfg, params, deltas, steps, quantize=False):
    """The reference's ``_run_cycles`` in both packages from the same numpy
    params and per-step deltas (``quantize`` rounds after each jump)."""
    jacc, tacc = JAcc(jcfg), TAcc(tcfg, device="cpu")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jb, tb = jacc.init(jp), tacc.init(tp)
    jg, tg = jacc.init_grams(jb), tacc.init_grams(tb)
    for t in range(steps):
        jp = {k: v + jnp.asarray(deltas[k]) for k, v in jp.items()}
        tp = {k: v + torch.tensor(deltas[k]) for k, v in tp.items()}
        jb, jg = jacc.record(jb, jp, jacc.slots(t), jg)
        tb, tg = tacc.record(tb, tp, tacc.slots(t), tg)
        if tacc.should_apply(t):
            jp, _ = jacc.apply({k: v.copy() for k, v in jp.items()}, jb,
                               grams=jg, step=t)
            tp, _ = tacc.apply(tp, tb, grams=tg, step=t)
            if quantize:
                jp = {k: jnp.round(v) for k, v in jp.items()}
                tp = {k: torch.round(v) for k, v in tp.items()}
    return (jacc, jp, jb, jg), (tacc, tp, tb, tg)


def test_bucket_scope_single_system_bucket_bitexact_leaf():
    """One single-system bucket: the two scopes are the same program, so
    bucket scope is bit-exact with leaf scope (params, buffers, Grams),
    and with the reference's bucket scope."""
    rng = np.random.default_rng(23)
    sizes = {"w": (8, 25)}
    params = _int_flat(rng, sizes)
    deltas = {k: rng.integers(-2, 3, size=v).astype(np.float32)
              for k, v in sizes.items()}
    jl, tl = _bcfg()
    jb, tb = _bcfg(scope="bucket")
    _, (_, p_l, b_l, g_l) = _run_both(jl, tl, params, deltas, 9, True)
    (_, jp, jbuf, jg), (acc, p_b, b_b, g_b) = _run_both(
        jb, tb, params, deltas, 9, True)
    (b,) = acc.arena_for(p_b).values()
    assert b.bucket_scoped("bucket") and b.n_sys == 1
    assert torch.equal(p_b["w"], p_l["w"])
    np.testing.assert_array_equal(p_b["w"].numpy(), np.asarray(jp["w"]))
    for key in b_l["__arena__"]:
        assert torch.equal(b_b["__arena__"][key], b_l["__arena__"][key])
        assert torch.equal(g_b["__arena__"][key], g_l["__arena__"][key])
        np.testing.assert_array_equal(g_b["__arena__"][key].numpy(),
                                      np.asarray(jg["__arena__"][key]))


def test_bucket_scope_gram_is_segment_sum_across_wraps():
    """After the ring wraps, the (1, m, m) bucket Gram equals the leaf-scope
    run's Gram stack summed over systems (integer data: bit-exact), the
    dot_general oracle on the anchored leaf-wise snapshots, and the
    reference's bucket Gram; params after two jumps equal the reference's
    (rounded after each jump, so both stay integer)."""
    from repro_torch.train.state import TrainState
    rng = np.random.default_rng(29)
    sizes = {"a": (7,), "b": (10, 13), "c": (333,), "d": (2, 5, 6)}
    params = _int_flat(rng, sizes)
    deltas = {k: rng.integers(-2, 3, size=v).astype(np.float32)
              for k, v in sizes.items()}
    jl, tl = _bcfg()
    jb, tb = _bcfg(scope="bucket")
    _, (_, _, _, g_l) = _run_both(jl, tl, params, deltas, 8, True)
    (_, jp, _, jg), (acc, p_b, b_b, g_b) = _run_both(jb, tb, params, deltas,
                                                     8, True)
    (key,) = g_b["__arena__"]
    gb = g_b["__arena__"][key].numpy()
    assert gb.shape == (1, 4, 4)
    np.testing.assert_array_equal(
        gb, g_l["__arena__"][key].numpy().sum(axis=0, keepdims=True))
    np.testing.assert_array_equal(gb, np.asarray(jg["__arena__"][key]))
    lw = acc.state_leafwise(TrainState(p_b, None, torch.tensor(8), b_b, g_b))
    rows = []
    for k in sorted(sizes):
        x = lw.dmd_buffers[k].numpy().reshape(4, -1)
        rows.append(x - x[0])
    d = np.concatenate(rows, axis=1)
    np.testing.assert_array_equal(gb[0], d @ d.T)
    for k in sizes:
        np.testing.assert_array_equal(p_b[k].numpy(), np.asarray(jp[k]))


def test_bucket_scope_bf16_gram_upcast_false_segment_sum():
    """bf16 snapshots with gram_upcast=False in bucket scope: the (1, m, m)
    Gram stays fp32 and equals the leaf-scope stack's sum (rtol 1e-5, atol
    1e-4: fp32 order) and the reference's bucket Gram (same bound); the
    params stay finite."""
    rng = np.random.default_rng(31)
    sizes = {"w": (24, 9), "v": (130,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in sizes.items()}
    deltas = {k: (0.05 * rng.normal(size=s)).astype(np.float32)
              for k, s in sizes.items()}
    kw = dict(snapshot_dtype="bfloat16", gram_upcast=False, anchor="first",
              tol=1e-3)
    jl, tl = _bcfg(**kw)
    jb, tb = _bcfg(scope="bucket", **kw)
    _, (_, _, _, g_l) = _run_both(jl, tl, params, deltas, 3)
    (_, _, _, jg), (_, p_b, _, g_b) = _run_both(jb, tb, params, deltas, 3)
    for key, g in g_b["__arena__"].items():
        assert g.dtype == torch.float32 and g.shape[0] == 1, key
        np.testing.assert_allclose(g[0].numpy(),
                                   g_l["__arena__"][key].numpy().sum(0),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg["__arena__"][key]),
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    for k in sizes:
        assert torch.isfinite(p_b[k]).all(), k


def test_bucket_scope_tables_and_spectrum():
    """layout_table and plan_table carry the scope and n_solve collapses to
    1 (as the reference's); spectrum_table renders one row per bucket
    from the carried Gram, from K3's recompute under the scope's table
    (the same row on integer data), and the reference's own table, in
    both scopes."""
    rng = np.random.default_rng(37)
    sizes = {"w": (16, 16), "b": (48,)}
    params = _int_flat(rng, sizes)
    jb, tb = _bcfg(scope="bucket")
    jacc, acc = JAcc(jb), TAcc(tb, device="cpu")
    jtable = jacc.arena_for({k: jnp.asarray(v) for k, v in params.items()})
    table = acc.arena_for({k: torch.tensor(v) for k, v in params.items()})
    (b,) = table.values()
    assert b.gram_lead("bucket") == 1 and b.gram_lead("leaf") == b.n_sys
    assert (b.scope_block_sys("bucket") == 0).all()
    for scope in ("bucket", "leaf"):
        assert _project(tarena.layout_table(table, scope=scope)) == \
            _project(jarena.layout_table(jtable, scope=scope))
    assert tarena.layout_table(table, scope="bucket")[0]["n_solve"] == 1
    lines = acc.plan_table().splitlines()
    assert lines[0].split()[-2:] == ["scope", "n_solve"]
    assert all(ln.split()[-2:] == ["bucket", "1"] for ln in lines[1:])
    deltas = {k: rng.integers(-2, 3, size=v).astype(np.float32)
              for k, v in sizes.items()}
    for scope in ("bucket", "leaf"):
        jc, tc = _bcfg(scope=scope)
        (jacc, _, jbuf, jg), (acc, _, tbuf, tg) = _run_both(
            jc, tc, params, deltas, 4)
        carried = acc.spectrum_table(tbuf, tg)
        assert "|lam|max" in carried and "decay/step" in carried
        assert carried == jacc.spectrum_table(jbuf, jg)
        assert acc.spectrum_table(tbuf) == carried       # K3's recompute
        assert carried.splitlines()[1].split()[1] == scope
    with pytest.raises(ValueError):
        TAcc(TCfg(), device="cpu").spectrum_table(tbuf)


def test_bucket_scope_unknown_scope_raises():
    _, tp = _both_params({"l0": {"w": (16, 16)}})
    (b,) = TAcc(TCfg(), device="cpu").arena_for(tp).values()
    with pytest.raises(ValueError, match="scope"):
        b.bucket_scoped("global")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jump_keeps_params_finite_block_range_by_block_range(dtype,
                                                             monkeypatch):
    """The jump's selection (K2's output where finite, else the last
    snapshot), a few blocks at a time and cast to the params' dtype, is
    the one-pass selection bit for bit; in fp32 it is written in place."""
    gen = torch.Generator().manual_seed(0)
    nb, m, bn = 5, 3, 8
    buf = torch.randn((nb, m, bn), generator=gen).to(torch.bfloat16)
    flat = torch.randn(nb * bn, generator=gen)
    flat[3], flat[17], flat[39] = float("inf"), float("nan"), -float("inf")
    want = torch.where(torch.isfinite(flat.view(nb, bn)), flat.view(nb, bn),
                       buf[:, -1, :].float()).reshape(-1).to(dtype)
    monkeypatch.setattr(tarena, "FINITE_BLOCKS", 2)
    got = tarena._finite_or_last(flat.clone(), buf, dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    if dtype == torch.float32:
        inplace = flat.clone()
        assert tarena._finite_or_last(inplace, buf, dtype).data_ptr() \
            == inplace.data_ptr()
