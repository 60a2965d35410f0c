"""Host-side training loop: the DMD schedule, the jump controller, CUDA
graphs.

    trainer = Trainer(MLPModel(PAPER_SIZES), acfg)        # device="cuda"
    state = trainer.fit(batches, steps)

(``python -m repro_torch.launch.train_mlp`` drives it on the paper MLP.)

The loop is thin: the math lives in the step functions of
``train/step.py``. The host decides, per step, the slot vector of the
fused train step (which schedule groups record, and where) and which
groups jump (``acc.apply_groups``), and dispatches the jump, loss-gated on
a held-out batch when ``dmd.controller.enabled``.

On a CUDA device the non-jump steps replay captured CUDA graphs: the
counterpart of the reference's ``jax.jit(..., donate_argnums=(0,))``
(``_GraphedSteps``). There is one graph per distinct slot vector: the
plain step (no group records) and one per record slot. The first step of
each kind runs eagerly on the capture stream (the warm-up: it allocates
the kernels' ticket buffer and segment tables for that stream, loads the
kernel library and cuBLAS), the second is captured and replayed, every
later one replayed. The batch is copied into static input tensors before
each replay; the step counter, the lr and the bias corrections are device
tensors inside the graph; the graphs' temporaries live in one memory pool
that the graphs of a ``fit`` call share, so a replay allocates nothing and
reads nothing back. A
capture error is an error: nothing falls back to eager steps. The kernel
wrappers count their launches when Python calls them, which a replay
does not: the capture's counts (the launches it recorded, none of which
ran) are taken back, and every replay adds them again, so each wrapper's
count stays the number of times its kernel ran. The jump
step runs eagerly (in eig mode it reads the operator back to the host for
its eigendecomposition, which no capture may do). ``cuda_graphs=False`` runs every step eagerly on a
CUDA device (the comparison run); on the CPU every step runs eagerly,
which is how the tests drive the Trainer.

With a ``checkpoint_dir`` (argument or ``train.checkpoint_dir``) ``fit``
resumes from the newest checkpoint there, saves every
``train.checkpoint_every`` steps and, on SIGTERM, saves after the
current step and returns. Checkpoints are in the reference's format and
per-leaf layout (``checkpoint/``, ``DMDAccelerator.state_leafwise``), so
either package restores the other's; a resumed run is bit-identical to
an uninterrupted one (the data stream is a function of the step index,
and every schedule position is derived from the restored step).

Under a mesh (``Trainer(model, acfg, mesh=...)``, ``launch/mesh.py``) every
rank runs this loop on its blocks of the state (``train/step.py``). The
params are drawn in full on every rank from the same seed and cut to the
rank's blocks, so a mesh run starts where a one-card run starts. Every
host decision is one that all ranks take alike: the schedule is a
function of the step, the losses and the gate's flags are global, the
coefficients are broadcast, and a SIGTERM on any rank stops every rank
after the same step (one all-reduce of the flag a step). Checkpoints are
gathered and written by the first rank in the one-card format, and
``restore`` places every leaf against the CURRENT mesh, so a run saved on
(2, 2) resumes on (4, 1), on (1, 4) or on one card. CUDA graphs cannot
capture gloo's collectives: a mesh Trainer asked for graphs on a card
raises.
"""
from __future__ import annotations

import signal
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint import (latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.core.accelerator import DMDAccelerator
from repro_torch.core import controller as ctrl_mod
from repro_torch.core import snapshots as snap
from repro_torch.core.paths import leaves_with_paths, map_with_paths
from repro_torch.distributed.sharding import gather_full, shard_tree
from repro_torch.data.tokens import stream_kwargs, validation_batch
from repro_torch.kernels import arena as _ka
from repro_torch.kernels import combine as _kc
from repro_torch.kernels import flash_attention as _kf
from repro_torch.kernels import gram as _kg
from repro_torch.kernels import gram_row as _kgr
from repro_torch.kernels.device import resolve_device
from repro_torch.launch.inputs import state_specs
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train.state import TrainState
from repro_torch.train.step import (make_dmd_step, make_train_step,
                                    model_stack_dims, state_resident,
                                    state_unresident)

PyTree = Any
PLAIN = ()                          # graph key of a step that records nothing
# the launch counters of the kernels a train step can launch
_COUNTERS = (_ka.LAUNCHES, _ka.BWD_LAUNCHES, _kgr.LAUNCHES,
             _kgr.BWD_LAUNCHES, _kc.LAUNCHES, _kg.LAUNCHES, _kf.LAUNCHES)


def _clone(tree: PyTree) -> PyTree:
    return map_with_paths(lambda _, x: x.clone(), tree)


def graph_key(slots) -> tuple:
    """The graph a train step replays: ``PLAIN`` when no group records
    (``slots`` None or all negative), else the slot vector with -1 for the
    groups not recording."""
    if slots is None or (np.asarray(slots) < 0).all():
        return PLAIN
    return tuple(int(s) for s in np.maximum(slots, -1))


def _counts() -> list:
    return [dict(c) for c in _COUNTERS]


def _add_counts(delta: list, sign: int) -> None:
    for counter, d in zip(_COUNTERS, delta):
        for k, v in d.items():
            counter[k] += sign * v


_CAPTURE_STREAMS: Dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The one side stream per device every ``fit`` warms up and captures
    on: what the kernels and cuBLAS keep per stream (the ticket buffer,
    the workspaces) is made once, not once per ``fit``."""
    if device not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return _CAPTURE_STREAMS[device]


class _GraphedSteps:
    """The fused train step as CUDA graphs, one per key (the slot vector of
    the recording groups, ``PLAIN`` for none). Keyed graphs hold the
    addresses of one state's tensors: build one per ``fit`` call; it, its
    graphs and their pool go with ``fit``'s return (no reference cycle
    holds them). Every graph is captured into one shared memory pool:
    replays run one at a time and their outputs are cloned, so the
    graphs' temporaries may overlap, and the pool holds one step's
    activations instead of one per graph (15 at the default m of 14)."""

    def __init__(self, train_step, device: torch.device):
        self.train_step = train_step
        self.side = _capture_stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, tuple] = {}    # key -> (graph, outs, counts)
        self.warm: set = set()
        self.static_batch: Optional[PyTree] = None
        self.stats = {"eager": 0, "captured": 0, "replayed": 0,
                      "emptied": 0}

    def _stage(self, batch: PyTree) -> PyTree:
        """Copy `batch` into the static input tensors (made on first use,
        outside any capture); a batch that already is them is not
        copied."""
        if self.static_batch is None:
            self.static_batch = _clone(batch)
            return self.static_batch
        src = dict(leaves_with_paths(batch))
        for path, dst in leaves_with_paths(self.static_batch):
            if src[path].data_ptr() != dst.data_ptr():
                dst.copy_(src[path], non_blocking=True)
        return self.static_batch

    def _make_room(self) -> None:
        """Before a capture: a capture allocates from its private pool
        alone, and the allocator cannot give cached blocks back to the
        device while it captures. Where the device has less free than the
        cache holds unused (the warm-up's temporaries: about what the
        capture takes), the cache goes back first (``stats["emptied"]``);
        a fit with room to spare keeps it."""
        dev = self.side.device
        free, _ = torch.cuda.mem_get_info(dev)
        if free < (torch.cuda.memory_reserved(dev)
                   - torch.cuda.memory_allocated(dev)):
            torch.cuda.empty_cache()
            self.stats["emptied"] += 1

    def __call__(self, state, batch, slots, key) -> dict:
        batch = self._stage(batch)
        entry = self.graphs.get(key)
        if entry is None:
            main = torch.cuda.current_stream()
            self.side.wait_stream(main)
            if key not in self.warm:
                # warm-up: this step, eagerly, on the capture stream
                with torch.cuda.stream(self.side):
                    _, metrics = self.train_step(state, batch, slots)
                main.wait_stream(self.side)
                self.warm.add(key)
                self.stats["eager"] += 1
                return metrics
            before = _counts()
            self._make_room()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self.side, pool=self.pool):
                _, outs = self.train_step(state, batch, slots)
            main.wait_stream(self.side)
            # the launches the capture recorded ran nowhere yet
            delta = [{k: c[k] - b[k] for k in c}
                     for c, b in zip(_counts(), before)]
            _add_counts(delta, -1)
            entry = self.graphs[key] = (graph, outs, delta)
            self.stats["captured"] += 1
        graph, outs, delta = entry
        graph.replay()
        _add_counts(delta, +1)
        self.stats["replayed"] += 1
        # the graph's outputs are overwritten by its next replay
        return {k: v.clone() for k, v in outs.items()}


class Trainer:
    def __init__(self, model, acfg, *, loss_fn: Optional[Callable] = None,
                 checkpoint_dir: Optional[str] = None,
                 fail_at_step: Optional[int] = None,
                 val_batch: Optional[PyTree] = None,
                 on_publish: Optional[Callable] = None,
                 device="cuda", cuda_graphs: bool = True, mesh=None):
        """`on_publish(params_leafwise, version)` is called after every jump
        the controller did not reject (every jump when it is off).
        `val_batch` is the controller's gate batch, disjoint from the
        training stream. `cuda_graphs=False` runs a CUDA Trainer's steps
        eagerly. Under `mesh` the state is this rank's blocks; on a card
        it needs ``cuda_graphs=False``."""
        self.model = model
        self.acfg = acfg
        self.mesh = mesh
        self.device = resolve_device(device)
        if mesh is not None and cuda_graphs and self.device.type == "cuda":
            raise ValueError(
                "a mesh Trainer cannot capture its steps as CUDA graphs (a "
                "graph cannot capture gloo's collectives; NCCL capture is "
                "not ported): pass cuda_graphs=False")
        self.on_publish = on_publish
        # one accelerator, hence one plan table, for the schedule and both
        # steps
        self.acc = DMDAccelerator(
            acfg.dmd, device=self.device,
            stack_dims=model_stack_dims(model), mesh=mesh)
        self.opt = make_optimizer(acfg.optimizer)
        self.checkpoint_dir = checkpoint_dir or acfg.train.checkpoint_dir
        self.fail_at_step = fail_at_step
        self._preempted = False
        self.train_step = make_train_step(model, acfg, loss_fn=loss_fn,
                                          acc=self.acc, device=self.device)
        self.controller_on = self.acc.controller_on
        self.dmd_step = make_dmd_step(acfg, acc=self.acc, model=model,
                                      loss_fn=loss_fn, device=self.device)
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self.graph_stats: Dict[str, int] = {}
        # the controller's persistent validation split: carved once, never
        # drawn from the training iterator
        self.val_batch = None
        if self.controller_on:
            self.val_batch = (self._to_device(val_batch)
                              if val_batch is not None
                              else self._carve_val_batch())

    def _to_device(self, batch: PyTree) -> PyTree:
        return map_with_paths(
            lambda _, x: torch.as_tensor(x).to(self.device), batch)

    def _publish(self, state, info, version: int) -> None:
        """The serving publish hook for a non-rejected jump (a rejected one
        left the weights as they were); under a mesh every rank gathers the
        full params and publishes them."""
        if self.controller_on and info.get("ctrl_outcome") == ctrl_mod.REJECT:
            return
        params = self.acc.params_leafwise(state.params)
        if self.mesh is not None:
            params = map_with_paths(lambda p, x: gather_full(
                x, self.acc.param_specs[p], self.mesh), params)
        self.on_publish(params, version)

    def _carve_val_batch(self) -> Optional[PyTree]:
        """The default validation split for vocab models: one batch at the
        token stream's reserved ``VAL_FOLD`` offset, shaped like a training
        batch (with a VLM's M-RoPE positions and an enc-dec model's
        frames). Models without a vocab (the MLP) have none and pass
        ``val_batch`` or ``fit(eval_batch=...)``."""
        mc = getattr(self.model, "cfg", None)
        vocab = getattr(mc, "vocab_size", None)
        if not vocab:
            return None
        tc = self.acfg.train
        return validation_batch(tc.seed, tc.global_batch, tc.seq_len, vocab,
                                device=self.device, **stream_kwargs(mc))

    # -- state ---------------------------------------------------------------
    def init_state(self, key: Optional[torch.Generator] = None,
                   params: Optional[PyTree] = None) -> TrainState:
        """A fresh state on the Trainer's device. `params` (e.g. the
        reference's init through ``convert.params_from_jax``) replaces the
        model's init from `key` (default: a generator seeded with
        ``train.seed`` on the device the model draws on: an LM's, the
        host for the MLP). Under a mesh `params` are the FULL params (every
        rank draws the same ones) and the state holds this rank's
        blocks."""
        if params is None:
            # a model draws on its own device (an LM on the card), the
            # MLP on the host
            gen = key if key is not None else torch.Generator(
                device=getattr(self.model, "device", "cpu")).manual_seed(
                    self.acfg.train.seed)
            params = self.model.init(gen)
        params = map_with_paths(lambda _, x: x.to(self.device), params)
        if self.mesh is not None:
            self.acc.plans_for(params)        # the table, from full shapes
            params = shard_tree(params, self.acc.param_specs, self.mesh)
        opt_state = self.opt.init(params)
        bufs = self.acc.init(params) if self.acfg.dmd.enabled else None
        grams = self.acc.init_grams(bufs)
        return TrainState(params, opt_state,
                          torch.zeros((), dtype=torch.int32,
                                      device=self.device),
                          bufs, grams, self.acc.init_controller())

    # -- checkpointing --------------------------------------------------------
    def save(self, state: TrainState, step: int):
        """Write `state` (per-leaf or resident) as checkpoint `step` in the
        per-leaf layout, keeping ``train.keep_checkpoints``. Every tensor
        is copied to the host, synchronously on the current stream,
        before this returns: the next replayed step writes the state in
        place."""
        if not self.checkpoint_dir:
            return
        leafwise = self.acc.state_leafwise(state)
        save_checkpoint(self.checkpoint_dir, leafwise, step,
                        keep=self.acfg.train.keep_checkpoints,
                        mesh=self.mesh, specs=self._specs(leafwise))

    def _specs(self, leafwise) -> Optional[dict]:
        """{key string: Spec} of a leaf-wise state under the mesh."""
        if self.mesh is None:
            return None
        return state_specs(leafwise, self.acc.plans_for(leafwise.params),
                           self.acc.param_specs)

    def restore(self, state_like: Optional[TrainState] = None
                ) -> Optional[TrainState]:
        """The newest checkpoint as a state in this Trainer's layout (arenas
        packed, params per leaf), on the template's device; None without
        one. The template is `state_like` or ``init_state()``; its leaves
        the checkpoint lacks keep their value. Grams a checkpoint carries
        all zero beside a non-zero buffer (written before streaming) are
        rebuilt from the buffers. Under a mesh each rank keeps its blocks
        of every leaf under this Trainer's mesh, whatever mesh wrote the
        checkpoint; then the state is packed into this mesh's buckets."""
        if not self.checkpoint_dir or latest_step(self.checkpoint_dir) is None:
            return None
        template = state_like if state_like is not None else self.init_state()
        template = self.acc.state_leafwise(template)
        state = restore_checkpoint(self.checkpoint_dir, template,
                                   mesh=self.mesh,
                                   specs=self._specs(template))
        if self.acc.streaming and state.dmd_gram is not None:
            state = state._replace(dmd_gram=snap.recompute_grams(
                state.dmd_gram, state.dmd_buffers, self.acfg.dmd,
                self.acc.plans_for(state.params)))
        return self.acc.state_arenaize(state)

    def _install_preempt_handler(self) -> Callable[[], None]:
        """SIGTERM sets the preemption flag; returns what puts the handler
        it replaced back. The handler refers to this Trainer: left behind,
        it would keep the Trainer (its step's persistent buffers) alive
        after ``fit``."""
        def handler(signum, frame):
            self._preempted = True
        try:
            previous = signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return lambda: None           # not on the main thread (tests)
        return lambda: signal.signal(
            signal.SIGTERM,
            signal.SIG_DFL if previous is None else previous)

    def _gate_batch(self, eval_batch: Optional[PyTree]) -> PyTree:
        """The controller's gate batch: the validation split (preferred
        over `eval_batch` with ``val_gate``), sliced to ``eval_rows``
        clamped to the batch's rows. Never a training batch."""
        ccfg = self.acfg.dmd.controller
        if ccfg.val_gate and self.val_batch is not None:
            eval_batch = self.val_batch
        elif eval_batch is None:
            eval_batch = self.val_batch
        else:
            eval_batch = self._to_device(eval_batch)
        if eval_batch is None:
            raise ValueError(
                "controller mode needs a gate batch disjoint from the "
                "training stream: pass fit(eval_batch=...) or "
                "Trainer(val_batch=...)")
        rows = ccfg.eval_rows
        if rows:
            n_rows = min(int(x.shape[0]) for _, x in
                         leaves_with_paths(eval_batch))
            rows = min(int(rows), n_rows)
            eval_batch = map_with_paths(lambda _, x: x[:rows], eval_batch)
        return eval_batch

    # -- the loop --------------------------------------------------------------
    def fit(self, batches: Iterator[PyTree], steps: int,
            state: Optional[TrainState] = None, log_every: int = 0,
            on_metrics: Optional[Callable] = None,
            eval_batch: Optional[PyTree] = None) -> TrainState:
        """Train up to step `steps` (from ``state.step``). `eval_batch`
        (controller mode) is the gate batch when there is no validation
        split or ``val_gate`` is off. Returns the per-leaf state. The
        given state's tensors are updated in place (its step counter,
        buffers and Grams, and its params and moments unless they are
        packed for residency): like the reference's donated state, do not
        reuse it; use the returned one. SIGTERM during the fit saves after
        the current step and returns."""
        restore_handler = self._install_preempt_handler()
        try:
            return self._fit(batches, steps, state, log_every, on_metrics,
                             eval_batch)
        finally:
            restore_handler()
            # the step's persistent gradient sums go with the fit (with
            # its graphs, which hold their addresses)
            self.train_step.release()

    def _fit(self, batches, steps, state, log_every, on_metrics,
             eval_batch) -> TrainState:
        resumed = self.restore(state)
        if resumed is not None:
            state = resumed
        elif state is None:
            state = self.init_state()
        # residency for the loop's duration: params and elementwise moments
        # live in the bucket buffers; expanded back before returning
        state = state_resident(self.acc, self.acfg, state)
        start_step = int(state.step)
        ckpt_every = self.acfg.train.checkpoint_every
        gate = self._gate_batch(eval_batch) if self.controller_on else None
        graphed = (_GraphedSteps(self.train_step, self.device)
                   if self.cuda_graphs else None)
        dmd_on = self.acfg.dmd.enabled

        for step in range(start_step, steps):
            if self.fail_at_step is not None and step == self.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            batch = self._to_device(next(batches))
            slots = self.acc.slots(step) if dmd_on else None
            if graphed is not None:
                metrics = graphed(state, batch, slots, graph_key(slots))
            else:
                state, metrics = self.train_step(state, batch, slots)
            apply_groups = self.acc.apply_groups(step) if dmd_on else ()
            if apply_groups:
                relax = self.acc.relax_vector(step)
                if self.controller_on:
                    state, info = self.dmd_step(state, relax, gate,
                                                groups=apply_groups)
                else:
                    state, info = self.dmd_step(state, relax,
                                                groups=apply_groups)
                metrics.update(info)
                if self.on_publish is not None:
                    self._publish(state, info, step + 1)
            if log_every and step % log_every == 0 and (
                    self.mesh is None or self.mesh.rank == 0):
                print(f"step {step}: loss={float(metrics['loss']):.6f}")
            if on_metrics is not None:
                on_metrics(step, metrics)
            if ckpt_every and (step + 1) % ckpt_every == 0:
                self.save(state, step + 1)
            if self.mesh is not None:
                # every rank stops after the same step
                self._preempted = self.mesh.any_(self._preempted)
            if self._preempted:
                self.save(state, step + 1)
                print(f"preempted at step {step + 1}")
                break
        if graphed is not None:
            self.graph_stats = dict(graphed.stats)
        return state_unresident(self.acc, state)

