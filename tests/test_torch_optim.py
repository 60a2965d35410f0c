"""The port's optimizers and lr schedules against the reference's
``repro.optim`` on the cases of tests/test_optim.py, on the same numpy
inputs. The step is passed as a tensor, as the Trainer passes its device
counter.

Tolerances: one update agrees to rtol 1e-6 (fp32; ``pow``, ``sqrt`` and
``cos`` may differ by an ulp between the packages); a 30-60 step
trajectory to rtol 1e-5 (adam8bit: its int8 rounding may flip on an ulp,
so 2e-3 of the largest moment); schedules to rtol 1e-6. The constant and
linear-warmup schedules are bit-identical to the fp32 formula the port
used before its schedules took tensors."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import OptimizerConfig as JOpt
from repro.optim import (apply_updates as j_apply,
                         clip_by_global_norm as j_clip,
                         global_norm as j_norm, make_optimizer as j_make,
                         make_schedule as j_sched)
from repro.optim.optimizers import _dequantize as j_deq, _quantize as j_q
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.paths import leaves_with_paths
from repro_torch.optim import optimizers as topt
from repro_torch.optim.optimizers import (adam, apply_updates,
                                          clip_by_global_norm, global_norm,
                                          make_optimizer)
from repro_torch.optim.schedules import make_schedule

NAMES = ["sgd", "momentum", "adam", "adamw", "adafactor", "adam8bit"]


def _quad(seed=0, n=32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    H = (A @ A.T / n + 0.1 * np.eye(n, dtype=np.float32)).astype(np.float32)
    w_star = rng.normal(size=n).astype(np.float32)
    w0 = rng.normal(size=n).astype(np.float32)
    # a 2-D leaf too, so adafactor factors one
    m0 = rng.normal(size=(4, 8)).astype(np.float32)
    return H, w_star, {"w": w0, "m": m0}


def _grads_np(H, w_star, p):
    """Gradient of 0.5 (w - w*)^T H (w - w*) + 0.5 |m|^2, in numpy fp32."""
    return {"w": (H @ (p["w"] - w_star)).astype(np.float32),
            "m": p["m"].astype(np.float32)}


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("name", NAMES)
def test_trajectory_matches_reference(name):
    """Each optimizer through make_optimizer, 30 steps on the same
    gradients (computed in numpy from each package's own params)."""
    H, w_star, p0 = _quad()
    lr = {"adafactor": 0.5, "adam8bit": 0.15}.get(name, 5e-2)
    kw = dict(name=name, lr=lr, weight_decay=0.01 if name == "adamw" else 0)
    jo, to = j_make(JOpt(**kw)), make_optimizer(OptimizerConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for t in range(30):
        gj = _grads_np(H, w_star, _np(jp))
        gt = _grads_np(H, w_star, {k: v.numpy() for k, v in tp.items()})
        uj, js = jo.update({k: jnp.asarray(v) for k, v in gj.items()}, js,
                           jp, jnp.asarray(t, jnp.int32))
        ut, ts = to.update({k: torch.tensor(v) for k, v in gt.items()}, ts,
                           tp, torch.tensor(t, dtype=torch.int32))
        jp, tp = j_apply(jp, uj), apply_updates(tp, ut)
    for k in p0:
        want = np.asarray(jp[k])
        if name == "adam8bit":
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=0,
                                       atol=2e-3 * np.abs(want).max())
        else:
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
def test_one_update_and_state_match_reference(name):
    """One update from a non-zero state: updates and every state field."""
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=300).astype(np.float32),
         "m": rng.normal(size=(6, 9)).astype(np.float32)}
    g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
    kw = dict(name=name, lr=1e-2)
    jo, to = j_make(JOpt(**kw)), make_optimizer(OptimizerConfig(**kw))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    js, ts = jo.init(jp), to.init(tp)
    # two updates: the second starts from non-zero moments
    for t in (0, 7):
        uj, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js,
                           jp, jnp.asarray(t, jnp.int32))
        ut, ts = to.update({k: torch.tensor(v) for k, v in g.items()}, ts,
                           tp, torch.tensor(t, dtype=torch.int32))
    for k in p:
        np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    # both packages flatten NamedTuple fields in order, dict keys sorted
    jl = jax.tree_util.tree_leaves(js)
    tl = [v for _, v in leaves_with_paths(ts)]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
        if a.dtype == np.int8:
            assert np.abs(a.astype(np.int32) - b.numpy()).max() <= 1
        else:
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-9)


def test_adam_matches_numpy_reference():
    lr, b1, b2, eps = 1e-2, 0.9, 0.999, 1e-8
    opt = adam(lambda s: torch.tensor(lr), b1, b2, eps)
    params = {"w": torch.tensor([1.0, -2.0, 3.0])}
    grads_seq = [np.array([0.1, -0.2, 0.3], np.float32),
                 np.array([-0.5, 0.5, 0.0], np.float32),
                 np.array([1.0, 1.0, -1.0], np.float32)]
    state = opt.init(params)
    w_np = np.array([1.0, -2.0, 3.0])
    m = np.zeros(3)
    v = np.zeros(3)
    for t, g in enumerate(grads_seq):
        u, state = opt.update({"w": torch.tensor(g)}, state, params,
                              torch.tensor(t))
        params = apply_updates(params, u)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** (t + 1))
        vh = v / (1 - b2 ** (t + 1))
        w_np = w_np - lr * mh / (np.sqrt(vh) + eps)
    np.testing.assert_allclose(params["w"].numpy(), w_np, rtol=1e-5)


SCHEDULES = [
    dict(schedule="constant"),
    dict(schedule="constant", warmup_steps=7),
    dict(schedule="linear_warmup", warmup_steps=10),
    dict(schedule="cosine", warmup_steps=5, total_steps=50,
         min_lr_ratio=0.0),
    dict(schedule="cosine", warmup_steps=0, total_steps=40,
         min_lr_ratio=0.1),
    dict(schedule="wsd", warmup_steps=10, total_steps=100,
         decay_fraction=0.2, min_lr_ratio=0.1),
    dict(schedule="wsd", warmup_steps=0, total_steps=30,
         decay_fraction=0.5, min_lr_ratio=0.0),
]


@pytest.mark.parametrize("case", range(len(SCHEDULES)))
def test_schedules_match_reference(case):
    kw = dict(lr=0.3, **SCHEDULES[case])
    jf, tf = j_sched(JOpt(**kw)), make_schedule(OptimizerConfig(**kw))
    for step in range(0, 120, 3):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert got.item() == pytest.approx(want, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("warm", [0, 1, 7, 100])
def test_constant_schedule_bit_identical_to_host_formula(warm):
    """The fp32 formula of the host-int schedule this one replaced:
    base * min((step + 1) / warm, 1) in numpy fp32."""
    f = make_schedule(OptimizerConfig(lr=1e-3, warmup_steps=warm))
    for step in range(0, 150, 7):
        if warm == 0:
            want = np.float32(1e-3) * np.float32(1.0)
        else:
            want = np.float32(1e-3) * min(
                (np.float32(step) + np.float32(1.0)) / np.float32(warm),
                np.float32(1.0))
        assert f(torch.tensor(step, dtype=torch.int32)).numpy() == want
        assert f(step).numpy() == want             # a host int still works


def test_wsd_schedule_shape():
    cfg = OptimizerConfig(lr=1.0, schedule="wsd", warmup_steps=10,
                          total_steps=100, decay_fraction=0.2,
                          min_lr_ratio=0.1)
    f = make_schedule(cfg)
    assert float(f(0)) < 0.2
    assert abs(float(f(50)) - 1.0) < 1e-6
    assert abs(float(f(79)) - 1.0) < 0.06
    assert float(f(99)) < 0.2
    assert float(f(99)) >= 0.1 - 1e-6


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(size=7).astype(np.float32),
            "b": {"c": rng.normal(size=(3, 4)).astype(np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {"a": torch.tensor(tree["a"]), "b": {"c": torch.tensor(
        tree["b"]["c"])}}
    assert float(global_norm(tt)) == pytest.approx(float(j_norm(jt)),
                                                   rel=1e-6)
    for max_norm in (0.5, 1e3):
        cj, ct = j_clip(jt, max_norm), clip_by_global_norm(tt, max_norm)
        np.testing.assert_allclose(ct["b"]["c"].numpy(),
                                   np.asarray(cj["b"]["c"]), rtol=1e-6)
    assert abs(float(global_norm({"a": torch.tensor([3.0, 4.0])})) - 5) \
        < 1e-6


def test_grad_clip_in_factory():
    opt = make_optimizer(OptimizerConfig(name="sgd", lr=1.0, grad_clip=1.0))
    params = {"w": torch.zeros(2)}
    u, _ = opt.update({"w": torch.tensor([30.0, 40.0])}, opt.init(params),
                      params, torch.tensor(0))
    assert abs(float(global_norm(u)) - 1.0) < 1e-4


@pytest.mark.parametrize("shape", [(5,), (256,), (300,), (3, 7, 11)])
def test_quantize_roundtrip_matches_reference(shape):
    """The 256-block int8 quantizer: the same int8 values (up to a
    rounding tie) and scales, and the same dequantized tensor."""
    x = np.random.default_rng(8).normal(size=shape).astype(np.float32)
    qj, sj = j_q(jnp.asarray(x))
    qt, st = topt._quantize(torch.tensor(x))
    assert qt.dtype == torch.int8 and tuple(qt.shape) == qj.shape
    assert np.abs(qt.numpy().astype(np.int32)
                  - np.asarray(qj).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-7)
    np.testing.assert_allclose(
        topt._dequantize(qt, st, shape).numpy(),
        np.asarray(j_deq(qj, sj, shape)),
        atol=1.01 * float(np.asarray(sj).max()))


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="optimizer"):
        make_optimizer(OptimizerConfig(name="lion"))
    with pytest.raises(ValueError, match="schedule"):
        make_schedule(OptimizerConfig(schedule="step"))


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_in_place_update_is_the_update_bit_for_bit(name, clip, monkeypatch):
    """``update_`` (the train step's in-place form, a chunk of a leaf at a
    time) writes the bits ``update`` + ``apply_updates`` give, moments
    included, with chunks that split every leaf (CHUNK 7): five steps."""
    H, w_star, p0 = _quad(3)
    cfg = OptimizerConfig(name=name, lr=0.05, grad_clip=clip,
                          schedule="constant")
    opt = make_optimizer(cfg)
    monkeypatch.setattr(topt, "CHUNK", 7)
    pa = {k: torch.tensor(v) for k, v in p0.items()}
    pb = {k: v.clone() for k, v in pa.items()}
    sa, sb = opt.init(pa), opt.init(pb)
    for t in range(5):
        step = torch.tensor(t, dtype=torch.int32)
        g = {k: torch.tensor(v) for k, v in
             _grads_np(H, w_star, _np(pa)).items()}
        u, sa = opt.update(g, sa, pa, step)
        pa = apply_updates(pa, u)
        opt.update_(g, sb, pb, step)
        for (path, a), (_, b) in zip(leaves_with_paths((pa, sa)),
                                     leaves_with_paths((pb, sb))):
            assert torch.equal(a, b), (t, path)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam", "adamw"])
def test_init_in_place_is_init(name, monkeypatch):
    """``init_`` (the moments' reset after a jump, a chunk of every leaf at
    a time) leaves a used state equal to a fresh ``init``, bit for bit;
    a non-elementwise optimizer is refused."""
    monkeypatch.setattr(topt, "CHUNK", 7)
    opt = make_optimizer(OptimizerConfig(name=name, lr=0.05,
                                         schedule="constant"))
    gen = torch.Generator().manual_seed(0)
    p = {"a": torch.randn(13, generator=gen),
         "b": {"c": torch.randn((3, 5), generator=gen)}}
    state = opt.init(p)
    opt.update_({"a": torch.ones(13), "b": {"c": torch.ones((3, 5))}},
                state, p, torch.tensor(0, dtype=torch.int32))
    topt.init_(opt, state, p)
    for (path, a), (_, b) in zip(leaves_with_paths(state),
                                 leaves_with_paths(opt.init(p))):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError, match="elementwise"):
        topt.init_(make_optimizer(OptimizerConfig(name="adafactor")),
                   (), p)


def test_global_norm_sums_a_large_leaf_a_chunk_at_a_time(monkeypatch):
    """A leaf above CHUNK elements is squared and summed a chunk at a
    time (no leaf-sized square): the same norm to fp32 rounding; a leaf
    within CHUNK is summed as before, bit for bit."""
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(5, 11)).astype(np.float32))
    whole = global_norm({"x": x})
    monkeypatch.setattr(topt, "CHUNK", 7)
    assert float(global_norm({"x": x})) == pytest.approx(
        float(torch.sqrt((x.double() ** 2).sum())), rel=1e-6)
    assert float(whole) == pytest.approx(float(global_norm({"x": x})),
                                         rel=1e-6)
    small = torch.tensor([3.0, 4.0])
    assert torch.equal(global_norm({"s": small}),
                       torch.sqrt(torch.sum(torch.square(small))))
