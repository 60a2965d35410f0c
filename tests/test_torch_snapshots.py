"""The port's per-leaf DMD route against the reference's: ``core/snapshots.py``
against ``repro.core.snapshots`` on all three kernel routes, the Gram
helpers and ``combine_snapshots`` / ``dmd_extrapolate`` of ``core/dmd.py``,
and, inside the port, the arena route against the per-leaf route.

Trajectories are integer-valued (numpy-seeded), so every fp32 and bf16 sum
is exact in any order: buffers, Grams and (between the port's two routes)
post-jump params must match bit for bit. Random-data comparisons state
their tolerance where they are made."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import DMDConfig as JCfg
from repro.core import DMDAccelerator as JAcc
from repro.core import dmd as jdmd
from repro.core import snapshots as jsnap
from repro.core.schedule import DMDGroupRule as JRule
from repro_torch.configs.base import DMDConfig as TCfg
from repro_torch.core import arena as tarena
from repro_torch.core import dmd as tdmd
from repro_torch.core import snapshots as tsnap
from repro_torch.core.accelerator import DMDAccelerator as TAcc
from repro_torch.core.leafplan import plan_entries
from repro_torch.core.paths import by_path, map_with_paths
from repro_torch.core.schedule import DMDGroupRule as TRule

SIZES = {"a": (7,), "b": (10, 13), "seg": (3, 5, 6)}
CPU = torch.device("cpu")


def _int_tree(rng, sizes, lo=-8, hi=9):
    return {k: rng.integers(lo, hi, size=s).astype(np.float32)
            for k, s in sizes.items()}


def _t(tree, dtype=torch.float32):
    return {k: torch.tensor(v).to(dtype) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _eq(got: torch.Tensor, want, what=""):
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32), err_msg=what)


def _cfgs(**kw):
    rules = kw.pop("rules", ())
    return (JCfg(groups=tuple(JRule(**r) for r in rules), **kw),
            TCfg(groups=tuple(TRule(**r) for r in rules), **kw))


@pytest.mark.parametrize("storage", ["float32", "bf16-upcast",
                                     "bf16-no-upcast"])
@pytest.mark.parametrize("route", ["pallas_flat", "pallas_shard_map",
                                   "dot_general"])
def test_snapshots_match_reference(route, storage):
    """init_buffers / record / init_grams / update_grams (with the
    per-group slot vector and with ``group=``) / recompute_grams, step by
    step through two window wraps, bit-exact on integer trajectories. The
    stacked leaf "seg" has one DMD system per leading index; with no mesh
    the reference's ``kernels/sharded.py`` route reduces to per-system
    kernels, which the port runs as one launch."""
    dtype = "float32" if storage == "float32" else "bfloat16"
    jcfg, tcfg = _cfgs(
        m=4, s=5, warmup_steps=0, cooldown_steps=0, arena=False,
        kernel_route=route, snapshot_dtype=dtype,
        gram_upcast=storage != "bf16-no-upcast",
        rules=(dict(name="vecs", max_ndim=1, m=3),))
    rng = np.random.default_rng(3)
    p = _int_tree(rng, SIZES)
    deltas = _int_tree(rng, SIZES, -2, 3)
    jacc = JAcc(jcfg, stack_dims={"seg": 1})
    tacc = TAcc(tcfg, stack_dims={"/seg": 1}, device="cpu")
    jplans, tplans = jacc.plans_for(_j(p)), tacc.plans_for(_t(p))
    want_routes = [(q.path, q.route, q.group, q.stack_dims) for q in
                   jax.tree_util.tree_leaves(
                       jplans, is_leaf=lambda x: hasattr(x, "route"))]
    assert [(q.path, q.route, q.group, q.stack_dims)
            for q in plan_entries(tplans)] == want_routes

    jb = jsnap.init_buffers(_j(p), jcfg, jplans)
    tb = tsnap.init_buffers(_t(p), tcfg, tplans, CPU)
    jg = jsnap.init_grams(jb, jcfg, jplans)
    tg = tsnap.init_grams(tb, tplans)
    assert tg["seg"].shape == (3, 4, 4) and tg["a"].shape == (3, 3)
    tbdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for t in range(9):
        p = {k: v + deltas[k] for k, v in p.items()}
        slots = tacc.slots(t)
        np.testing.assert_array_equal(slots, jacc.slots(t))
        if t % 2:                      # one call per schedule group
            for gi in range(tacc.n_groups):
                jb = jsnap.record(jb, _j(p), slots, jplans, group=gi)
                jg = jsnap.update_grams(jg, jb, _j(p), slots, jcfg, jplans,
                                        group=gi)
                tsnap.record(tb, _t(p), slots, tplans, group=gi)
                tsnap.update_grams(tg, tb, slots, tcfg, tplans, group=gi)
        else:
            jb = jsnap.record(jb, _j(p), slots, jplans)
            jg = jsnap.update_grams(jg, jb, _j(p), slots, jcfg, jplans)
            tsnap.record(tb, _t(p), slots, tplans)
            tsnap.update_grams(tg, tb, slots, tcfg, tplans)
        for k in SIZES:
            assert tb[k].dtype == tbdtype
            _eq(tb[k], jb[k].astype(jnp.float32), f"step {t} buffer {k}")
            _eq(tg[k], jg[k], f"step {t} gram {k}")

    # a scalar slot writes every leaf; a negative one none
    before = {k: v.clone() for k, v in tb.items()}
    tsnap.record(tb, _t(p), -1, tplans)
    assert all(torch.equal(tb[k], before[k]) for k in SIZES)
    jb = jsnap.record(jb, _j(p), 1, jplans)
    tsnap.record(tb, _t(p), 1, tplans)
    for k in SIZES:
        _eq(tb[k], jb[k].astype(jnp.float32), f"scalar slot {k}")

    # recompute_grams rebuilds exactly the zeroed Grams
    jz = {**jg, "b": jnp.zeros_like(jg["b"]), "seg": jnp.zeros_like(jg["seg"])}
    tz = {**tg, "b": torch.zeros_like(tg["b"]),
          "seg": torch.zeros_like(tg["seg"])}
    jr = jsnap.recompute_grams(jz, jb, jcfg, jplans)
    tr = tsnap.recompute_grams(tz, tb, tcfg, tplans)
    assert tr["a"] is tz["a"]                    # live Grams pass through
    for k in SIZES:
        _eq(tr[k], jr[k], f"recomputed gram {k}")


def test_init_buffers_skip_paths_and_excluded_leaves():
    jcfg, tcfg = _cfgs(m=5, min_param_size=50)
    rng = np.random.default_rng(0)
    p = _int_tree(rng, SIZES)
    jplans = JAcc(jcfg, stack_dims={"seg": 1}).plans_for(_j(p))
    tplans = TAcc(tcfg, stack_dims={"/seg": 1}, device="cpu").plans_for(
        _t(p))
    jb = jsnap.init_buffers(_j(p), jcfg, jplans, skip_paths={"/b"})
    tb = tsnap.init_buffers(_t(p), tcfg, tplans, CPU, skip_paths={"/b"})
    assert jb["a"] is None and jb["b"] is None      # a: below 50 params
    assert tb == {"a": None, "b": None, "seg": tb["seg"]}
    assert tb["seg"].shape == jb["seg"].shape == (5, 3, 5, 6)
    tg = tsnap.init_grams(tb, tplans)
    assert tg["a"] is None and tg["seg"].shape == (3, 5, 5)


@pytest.mark.parametrize("stack_dims", [0, 1, 2])
@pytest.mark.parametrize("upcast", [True, False])
def test_dmd_gram_helpers_match_reference(stack_dims, upcast):
    """gram_matrix / gram_row_matrix / combine_snapshots with stacked
    systems, on bf16 snapshots (``upcast=False`` anchors and rounds c in
    bf16, as the reference does). Random data: |diff| <= 1e-5 * max(1,
    max|reference|), fp32 summation order."""
    rng = np.random.default_rng(stack_dims)
    shape = (6, 2, 3, 40)
    x = np.asarray(jnp.asarray(rng.normal(size=shape), jnp.bfloat16)
                   .astype(jnp.float32))
    c = rng.normal(size=shape[1:1 + stack_dims] + (6,)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.tensor(x).bfloat16()
    pairs = []
    for anchor in ("none", "first", "mean"):
        pairs.append((tdmd.gram_matrix(tx, anchor, stack_dims, upcast),
                      jdmd.gram_matrix(jx, anchor, stack_dims, upcast)))
    for anchor in ("none", "first"):
        pairs.append((tdmd.gram_row_matrix(tx, tx[3], anchor, stack_dims,
                                           upcast),
                      jdmd.gram_row_matrix(jx, jx[3], anchor, stack_dims,
                                           upcast)))
    pairs.append((tdmd.combine_snapshots(tx, torch.tensor(c), stack_dims,
                                         upcast),
                  jdmd.combine_snapshots(jx, jnp.asarray(c), stack_dims,
                                         upcast)))
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        tol = 1e-5 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("anchor", ["first", "mean", "none"])
def test_dmd_extrapolate_matches_reference(anchor):
    """One-leaf extrapolation of a noisy drift: |w_port - w_ref| <= 1e-3 *
    max(1, max|w_ref|) (the two packages' eigensolvers round differently
    and the s-step power amplifies it; the c bound of test_torch_dmd.py
    carried through S^T c). A non-finite snapshot falls back to the last
    snapshot, elementwise."""
    rng = np.random.default_rng(1)
    m, n = 8, 60
    t = np.arange(m)[:, None]
    S = (rng.normal(size=n) + 0.05 * t * rng.normal(size=n)
         + 0.002 * rng.normal(size=(m, n))).astype(np.float32)
    kw = dict(s=10, tol=1e-4, anchor=anchor, affine=True, trust_region=2.0)
    wj, ij = jdmd.dmd_extrapolate(jnp.asarray(S), **kw)
    wt, it = tdmd.dmd_extrapolate(torch.tensor(S), **kw)
    wj = np.asarray(wj)
    np.testing.assert_allclose(wt.numpy(), wj, rtol=0,
                               atol=1e-3 * max(1.0, np.abs(wj).max()))
    assert int(it["rank"]) == int(ij["rank"])
    S[2, 5] = np.inf
    wt, _ = tdmd.dmd_extrapolate(torch.tensor(S), **kw)
    assert torch.isfinite(wt).all()
    assert float(wt[5]) == float(S[-1, 5])


# ---------------------------------------------------------------------------
# Inside the port: the arena route against the per-leaf route
# ---------------------------------------------------------------------------

def _run_cycles(cfg, params, deltas, steps, stack_dims=None):
    """record / update / jump through the accelerator, rounding the params
    after every jump so every snapshot VALUE stays integer (the exactness
    precondition: the arena twin's part-anchor identity and the per-leaf
    explicit anchor then give the same bits)."""
    acc = TAcc(cfg, stack_dims=stack_dims, device="cpu")
    bufs = acc.init(params)
    grams = acc.init_grams(bufs)
    p = params
    for t in range(steps):
        p = {k: v + deltas[k] for k, v in p.items()}
        bufs, grams = acc.record(bufs, p, acc.slots(t), grams)
        if acc.should_apply(t):
            p, stats = acc.apply(p, bufs, grams=grams, step=t)
            assert torch.isfinite(stats["mean_rank"])
            p = map_with_paths(lambda _, x: torch.round(x), p)
    return acc, p, bufs, grams


def _arena_leafwise(acc, params, bufs, grams):
    """The arena state unpacked per leaf by the checkpoint views: {path:
    (m, *shape) buffer} and {path: (stack..., m, m) Gram}."""
    table = acc.arena_for(params)
    out_b = tarena.buffers_leafwise(table, bufs["__arena__"])
    out_g = ({} if grams is None
             else tarena.grams_leafwise(table, grams["__arena__"]))
    return out_b, out_g


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(streaming_gram=False),
    dict(anchor="mean"),
    dict(snapshot_dtype="bfloat16", gram_upcast=False),
])
def test_arena_vs_perleaf_bitexact_full_cycles(cfg):
    """Two full jump cycles (window wrap and second jump) on integer
    trajectories, the arena route and ``arena=False``: params, buffers and
    Grams bit-exact on every leaf, including sizes off the 128-lane grid
    and a stacked leaf (two systems). The port's copy of the reference's
    tests/test_arena.py arena-vs-per-leaf oracles (first and mean
    anchor)."""
    rng = np.random.default_rng(7)
    sizes = {"a": (7,), "b": (10, 13), "c": (333,), "d": (2, 5, 6)}
    params = _t(_int_tree(rng, sizes))
    deltas = _t(_int_tree(rng, sizes, -2, 3))
    base = TCfg(m=4, s=5, warmup_steps=0, cooldown_steps=0, tol=1e-6,
                **cfg)
    sd = {"/d": 1}
    acc_a, p_arena, bufs_a, grams_a = _run_cycles(base, params, deltas, 9,
                                                  sd)
    acc_o, p_leaf, bufs_o, grams_o = _run_cycles(
        dataclasses.replace(base, arena=False), params, deltas, 9, sd)
    assert "__arena__" in bufs_a and "__arena__" not in bufs_o
    assert by_path(bufs_a["leaf"]) == {}          # every leaf is packed
    for k in sizes:
        assert torch.equal(p_arena[k], p_leaf[k]), k
    lb, lg = _arena_leafwise(acc_a, p_arena, bufs_a, grams_a)
    for k in sizes:
        assert torch.equal(lb["/" + k], bufs_o[k]), k
        if grams_o is not None:
            assert torch.equal(lg["/" + k], grams_o[k]), k


def test_two_route_state():
    """With a bucket the state is the wrapper ``{"__arena__", "leaf"}``,
    the per-leaf tree None at every packed path (here: all of them, one
    bucket per schedule group); with the ``dot_general`` route forced no
    leaf is packed and the state is the plain per-leaf tree."""
    rng = np.random.default_rng(2)
    params = _t(_int_tree(rng, SIZES))
    cfg = TCfg(m=4, groups=(TRule(name="vecs", max_ndim=1, m=3),))
    acc = TAcc(cfg, device="cpu")
    bufs = acc.init(params)
    grams = acc.init_grams(bufs)
    assert set(bufs) == {"__arena__", "leaf"}
    assert set(bufs["__arena__"]) == {"g0-float32", "g1-float32"}
    assert bufs["leaf"] == {"a": None, "b": None, "seg": None}
    assert grams["leaf"] == bufs["leaf"]
    assert grams["__arena__"]["g1-float32"].shape == (1, 3, 3)
    acc = TAcc(dataclasses.replace(cfg, kernel_route="dot_general"),
               device="cpu")
    bufs = acc.init(params)
    assert set(bufs) == set(SIZES)
    assert bufs["a"].shape == (3, 7) and bufs["b"].shape == (4, 10, 13)
    assert acc.init_grams(bufs)["b"].shape == (4, 4)
