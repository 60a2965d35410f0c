"""Continuous-batching serving engine with live weight hot-swap.

The reference's engine, eager:

  * ``decode``: ONE batched step over the whole slot table. The per-request
    KV caches are rows of one ``(layers, n_slots, s_max, K, hd)`` cache with
    a per-slot length vector, so each slot decodes at its own position and
    writes its own cache row (the reference vmaps over slots instead).
    Sampling (greedy argmax, or top-k with a ``torch.Generator`` seeded
    from ``cfg.seed``) and the per-slot active mask stay on the device: a
    decode step reads nothing back to the host.
  * ``prefill``: prompts padded to a (batch bucket, prompt bucket) shape
    run through ``LanguageModel.prefill`` into fresh zeroed caches, so the
    attention core is the flash-attention kernel K7, once per layer.
  * ``insert``: the prefilled cache rows land in free slots; filler rows
    carry the sentinel slot ``n_slots`` and are dropped.

Segment kinds ``dense``, ``moe`` and ``moe_pair`` are served: their caches
are plain KVCaches (the moe_pair's a ``{"dense", "moe"}`` pair of them),
walked alike (MiniCPM's and Granite's too). Gemma's ``gemma`` and
``dense_local`` kinds are refused, as the reference's engine refuses
them: a window layer's ring cache holds the last W positions of ONE
length, which the per-slot table cannot share. An MoE prompt's routing depends on its padding: capacity is
per padded row, so a bucketed prompt's logits differ from an exact-length
run's (the reference's engine does the same); decode is drop-free (one
token per row keeps capacity 1).

Padded prompts keep their tokens: the insert sets the slot's cache length
to ``true_len - 1`` and its cursor to the prompt's last token, so the first
decode step recomputes the last prompt position's KV and logits at the
right offset; the decode core's chunk grid is absolute, so the padded keys
past the length add exact zeros to the online softmax.

Hot-swap: ``swap_weights`` lands new params in the double-buffered
``ParamStore`` (device-to-device copies, version bumped on the host).
Host dispatch is in order, so the flip lands between decode steps. With
``adopt="step"`` in-flight sequences take the new version at the next
step; with ``adopt="drain"`` it waits (admissions held) until every active
slot has finished.

The program registry is the reference's, eager: each bucket-shaped step
is a program keyed ``prefill_b{B}_p{P}``, ``insert_b{B}`` or ``decode``,
built once (``_program``; its first build is the "compile" the counters
count, ``stats["compiles"]``, and after ``mark_steady()`` also
``stats["steady_compiles"]``, which the audit's serve-compile pass pins at
zero). ``max_programs`` is the reference's ceiling: one decode, one
prefill per (prompt bucket, batch bucket), one insert per batch bucket
and the ParamStore's landing copy. ``audit_info`` and ``audit_targets``
feed ``repro_torch.audit`` (``serve/audit.py``); ``ServeConfig
.force_recompile`` is its mutation seam. A program is a bound method
here; capturing each as a CUDA graph is a later speed change.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.attention import KVCache
from repro_torch.serve.store import ParamStore

# Segment kinds whose caches are plain KVCaches the slot table can hold
SERVABLE_KINDS = ("dense", "moe", "moe_pair")


def _kv_map(fn, caches, *others):
    """`caches` with every KVCache replaced by fn(cache, *the same
    KVCache of each tree in `others`)."""
    if isinstance(caches, dict):
        return {k: _kv_map(fn, v, *(o[k] for o in others))
                for k, v in caches.items()}
    return fn(caches, *others)


@dataclass(frozen=True)
class ServeConfig:
    """Shape policy, sampling and swap adoption: the reference's fields.

    ``force_recompile`` is the audit's mutation seam (``repro_torch.audit
    .mutations`` ``force-recompile``): prompt "buckets" degrade to exact
    lengths, so every novel prompt length builds a fresh prefill program
    and the serve-compile pass's steady-state pin trips."""
    n_slots: int = 8
    prompt_buckets: Tuple[int, ...] = (16, 64)
    batch_buckets: Tuple[int, ...] = (1, 4)
    max_new_tokens: int = 32
    s_max: int = 0                  # 0 -> max(prompt_buckets) + max_new
    sampling: str = "greedy"        # "greedy" | "topk"
    top_k: int = 8
    temperature: float = 1.0
    seed: int = 0
    adopt: str = "step"             # "step" | "drain"
    force_recompile: bool = False


@dataclass
class Request:
    uid: int
    tokens: List[int]
    max_new_tokens: int


@dataclass
class Result:
    uid: int
    prompt_len: int
    tokens: List[int]
    last_logits: np.ndarray         # (padded_vocab,) fp32, final step
    version_start: int              # weights version at insert
    version_end: int                # weights version at completion


@dataclass
class _Slot:
    uid: int
    prompt_len: int
    target: int
    emitted: int
    version_start: int


class ServeEngine:
    """Slot-based continuous batching over one model and one ParamStore."""

    def __init__(self, model, params, cfg: Optional[ServeConfig] = None):
        """Serves `params` themselves, not a copy (``ParamStore``): the
        caller must not change them afterwards."""
        cfg = cfg if cfg is not None else ServeConfig()
        kinds = {seg.kind for seg in model.plan}
        bad = sorted(kinds - set(SERVABLE_KINDS))
        if bad:
            raise NotImplementedError(
                f"serve engine supports KV-cache segment kinds "
                f"{SERVABLE_KINDS}; config has {bad}")
        if model.scan_layers:
            raise ValueError("serve engine needs a model with unrolled "
                             "layers (scan_layers=False)")
        if model.cfg.mrope_sections:
            raise NotImplementedError(
                "mrope position batches are not wired into the slot table")
        for name in ("prompt_buckets", "batch_buckets"):
            b = tuple(getattr(cfg, name))
            if not b or b != tuple(sorted(set(b))):
                raise ValueError(f"{name} must be ascending and unique")
        if cfg.batch_buckets[-1] > cfg.n_slots:
            raise ValueError("largest batch bucket exceeds n_slots")
        if cfg.sampling not in ("greedy", "topk"):
            raise ValueError(f"unknown sampling {cfg.sampling!r}")
        if cfg.adopt not in ("step", "drain"):
            raise ValueError(f"unknown adopt policy {cfg.adopt!r}")
        s_need = max(cfg.prompt_buckets) + cfg.max_new_tokens
        if cfg.s_max and cfg.s_max < s_need:
            raise ValueError(f"s_max={cfg.s_max} < longest prompt bucket + "
                             f"max_new_tokens = {s_need}")

        self.model = model
        self.cfg = cfg
        self.device = model.device
        self._s_max = cfg.s_max or s_need
        self._store = ParamStore(params)
        self._programs: Dict[str, Callable] = {}
        self._steady = False
        self._gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._queue: deque = deque()
        self._slots: List[Optional[_Slot]] = [None] * cfg.n_slots
        self._pending = False           # drain-adopt: staged, not committed
        self._uid = 0
        self.stats = {"submitted": 0, "completed": 0, "dropped": 0,
                      "swaps": 0, "compiles": 0, "steady_compiles": 0,
                      "decode_dispatches": 0, "prefill_dispatches": 0,
                      "tokens_emitted": 0}
        self._dstate = self._init_dstate()

    # -- device state -------------------------------------------------------
    def _as_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _zeros(self, *shape, dtype=torch.long):
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _init_dstate(self) -> Dict[str, Any]:
        n = self.cfg.n_slots
        caches = _kv_map(lambda c: KVCache(c.k, c.v, self._zeros(n)),
                         self.model.init_cache(n, self._s_max))
        return {
            "caches": caches,
            "cur_tok": self._zeros(n, 1),
            "out_buf": self._zeros(n, self.cfg.max_new_tokens),
            "out_pos": self._zeros(n),
            "target": self._zeros(n),
            "last_logits": self._zeros(n, self.model.cfg.padded_vocab,
                                       dtype=torch.float32),
        }

    # -- program registry ---------------------------------------------------
    def _program(self, name: str, build: Callable[[], Callable]) -> Callable:
        """The program `name`, built by `build()` on first use: a first
        build counts as a compile (and as a steady compile after
        ``mark_steady``)."""
        prog = self._programs.get(name)
        if prog is None:
            prog = build()
            self._programs[name] = prog
            self.stats["compiles"] += 1
            if self._steady:
                self.stats["steady_compiles"] += 1
        return prog

    def mark_steady(self) -> None:
        """Warm-up is over: any program built after this is a steady-state
        recompile, the defect the serve-compile audit pass pins at 0."""
        self._steady = True

    @property
    def n_programs(self) -> int:
        return len(self._programs) + self._store.n_programs

    @property
    def max_programs(self) -> int:
        """The analytic ceiling: 1 decode + one prefill per (batch bucket
        x prompt bucket) + one insert per batch bucket + the ParamStore's
        landing copy."""
        npb = len(self.cfg.prompt_buckets)
        nbb = len(self.cfg.batch_buckets)
        return 1 + npb * nbb + nbb + self._store.n_programs

    @property
    def params(self):
        """The weights being served (the store's active buffer)."""
        return self._store.params

    @property
    def version(self) -> int:
        return self._store.version

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    # -- the three steps ----------------------------------------------------
    def _decode(self, params, d: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self.cfg
        logits, moved = self.model.decode_step(
            params, {"tokens": d["cur_tok"]}, d["caches"])
        # the step wrote k and v in place but moved each segment's per-slot
        # lengths on in a new tensor: written back, every tensor of the
        # slot table keeps its storage
        caches = d["caches"]
        _kv_map(lambda c, m: c.length.copy_(m.length), caches, moved)
        logits = logits[:, 0, :]                     # (n_slots, V) fp32
        if cfg.sampling == "greedy":
            tok = torch.argmax(logits, dim=-1)
        else:
            vals, idx = torch.topk(logits / cfg.temperature, cfg.top_k)
            pick = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                     generator=self._gen)
            tok = torch.gather(idx, -1, pick)[:, 0]
        # the device-side completion mask: no host read per step
        active = d["out_pos"] < d["target"]
        rows = torch.arange(cfg.n_slots, device=self.device)
        pos = d["out_pos"].clamp(0, cfg.max_new_tokens - 1)
        out_buf = d["out_buf"]
        out_buf[rows, pos] = torch.where(active, tok, out_buf[rows, pos])
        return {
            # inactive slots decode garbage harmlessly: their cache writes
            # clamp at s_max and an insert overwrites the row wholesale
            "caches": caches,
            "cur_tok": torch.where(active[:, None], tok[:, None],
                                   d["cur_tok"]),
            "out_buf": out_buf,
            "out_pos": d["out_pos"] + active.long(),
            "target": d["target"],
            "last_logits": torch.where(active[:, None], logits,
                                       d["last_logits"]),
        }

    def _prefill(self, params, toks: torch.Tensor) -> dict:
        caches = self.model.init_cache(toks.shape[0], self._s_max)
        _, filled = self.model.prefill(params, {"tokens": toks}, caches)
        return filled

    def _insert(self, pre_caches: dict, slots: np.ndarray,
                true_lens: np.ndarray, first_toks: np.ndarray,
                targets: np.ndarray) -> None:
        """Scatter the prefilled rows into their slots (in place); filler
        rows, whose slot is the sentinel n_slots, are dropped."""
        keep = slots < self.cfg.n_slots
        as_dev = self._as_device
        src, dst = as_dev(np.flatnonzero(keep)), as_dev(slots[keep])
        d = self._dstate
        lens = as_dev(true_lens[keep] - 1)

        def land(c, pre):
            c.k[:, dst] = pre.k[:, src]
            c.v[:, dst] = pre.v[:, src]
            # length = true_len - 1: the first decode step recomputes the
            # last prompt token's KV and logits at its own position
            c.length[dst] = lens
        _kv_map(land, d["caches"], pre_caches)
        d["cur_tok"][dst, 0] = as_dev(first_toks[keep])
        d["out_buf"][dst] = 0
        d["out_pos"][dst] = 0
        d["target"][dst] = as_dev(targets[keep])

    # -- bucketing ----------------------------------------------------------
    def _prompt_bucket(self, n: int) -> int:
        if n > self.cfg.prompt_buckets[-1]:
            raise ValueError(f"prompt length {n} exceeds the largest prompt "
                             f"bucket {self.cfg.prompt_buckets[-1]}")
        if self.cfg.force_recompile:
            return n        # the audit seam: exact lengths, fresh programs
        return next(b for b in self.cfg.prompt_buckets if n <= b)

    def _batch_bucket(self, n: int) -> int:
        return next(b for b in self.cfg.batch_buckets if n <= b)

    # -- request lifecycle --------------------------------------------------
    def submit(self, tokens: Sequence[int],
               max_new_tokens: Optional[int] = None) -> int:
        toks = [int(t) for t in tokens]
        if not toks:
            raise ValueError("empty prompt")
        self._prompt_bucket(len(toks))          # raises for oversize
        mn = int(max_new_tokens if max_new_tokens is not None
                 else self.cfg.max_new_tokens)
        if not 1 <= mn <= self.cfg.max_new_tokens:
            raise ValueError(
                f"max_new_tokens={mn} outside [1, {self.cfg.max_new_tokens}]")
        uid = self._uid
        self._uid += 1
        self._queue.append(Request(uid, toks, mn))
        self.stats["submitted"] += 1
        return uid

    def _admit(self) -> None:
        if self._pending:                       # drain-adopt holds admission
            return
        free = [i for i, s in enumerate(self._slots) if s is None]
        while free and self._queue:
            pb = self._prompt_bucket(len(self._queue[0].tokens))
            take = min(len(free), self.cfg.batch_buckets[-1])
            reqs: List[Request] = []
            while (self._queue and len(reqs) < take and self._prompt_bucket(
                    len(self._queue[0].tokens)) == pb):
                reqs.append(self._queue.popleft())
            Bb = self._batch_bucket(len(reqs))

            toks = np.zeros((Bb, pb), np.int64)
            slots = np.full((Bb,), self.cfg.n_slots, np.int64)  # sentinel
            true_lens = np.ones((Bb,), np.int64)
            first_toks = np.zeros((Bb,), np.int64)
            targets = np.ones((Bb,), np.int64)
            for r, req in enumerate(reqs):
                n = len(req.tokens)
                toks[r, :n] = req.tokens
                slots[r] = free.pop(0)
                true_lens[r] = n
                first_toks[r] = req.tokens[n - 1]
                targets[r] = req.max_new_tokens
            if len(reqs) < Bb:                  # filler rows: repeat row 0
                toks[len(reqs):] = toks[0]
                true_lens[len(reqs):] = true_lens[0]
                first_toks[len(reqs):] = first_toks[0]

            prefill = self._program(f"prefill_b{Bb}_p{pb}",
                                    lambda: self._prefill)
            pre = prefill(self._store.params, self._as_device(toks))
            self.stats["prefill_dispatches"] += 1
            insert = self._program(f"insert_b{Bb}", lambda: self._insert)
            insert(pre, slots, true_lens, first_toks, targets)
            for r, req in enumerate(reqs):
                self._slots[int(slots[r])] = _Slot(
                    uid=req.uid, prompt_len=len(req.tokens),
                    target=req.max_new_tokens, emitted=0,
                    version_start=self.version)

    def step(self) -> List[Result]:
        """One engine tick: commit a pending drain-swap if the table is
        empty, admit queued requests into free slots, run ONE decode step,
        and harvest completions."""
        self._maybe_commit_pending()
        self._admit()
        if all(s is None for s in self._slots):
            return []
        n_active = self.active_slots
        decode = self._program("decode", lambda: self._decode)
        self._dstate = decode(self._store.params, self._dstate)
        self.stats["decode_dispatches"] += 1
        self.stats["tokens_emitted"] += n_active
        finished: List[Result] = []
        for i, info in enumerate(self._slots):
            if info is None:
                continue
            # host mirror of the device-side active mask: one token per
            # step until the target, with no read back to find out
            info.emitted += 1
            if info.emitted >= info.target:
                finished.append(self._finish(i))
        return finished

    def _finish(self, slot: int) -> Result:
        info = self._slots[slot]
        toks = self._dstate["out_buf"][slot, :info.target].tolist()
        logits = self._dstate["last_logits"][slot].cpu().numpy()
        self._slots[slot] = None
        self.stats["completed"] += 1
        return Result(uid=info.uid, prompt_len=info.prompt_len,
                      tokens=[int(t) for t in toks], last_logits=logits,
                      version_start=info.version_start,
                      version_end=self.version)

    def run_until_drained(self, max_steps: int = 100_000) -> List[Result]:
        out: List[Result] = []
        steps = 0
        while (self._queue or any(s is not None for s in self._slots)
               or self._pending):
            out.extend(self.step())
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"drain stalled after {max_steps} steps "
                                   f"({self.queue_len} queued, "
                                   f"{self.active_slots} active)")
        return out

    def sync(self) -> None:
        """Wait until the enqueued device work is done (for timing)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- hot-swap -----------------------------------------------------------
    def swap_weights(self, params, version: Optional[int] = None) -> int:
        """Stage new weights (device-to-device copies into the standby
        buffer) and adopt them per ``cfg.adopt``. Returns the staged
        version."""
        self._store.stage(params, version)
        staged = self._store.staged_version
        if self.cfg.adopt == "drain":
            self._pending = True
            self._maybe_commit_pending()
        else:
            self._store.commit()
            self.stats["swaps"] += 1
        return staged

    def _maybe_commit_pending(self) -> None:
        if self._pending and all(s is None for s in self._slots):
            self._store.commit()
            self._pending = False
            self.stats["swaps"] += 1

    # -- audit hooks --------------------------------------------------------
    def audit_info(self) -> Dict[str, Any]:
        """The registry's counts, as the reference's engine reports them."""
        return {"n_programs": self.n_programs,
                "max_programs": self.max_programs,
                "compiles": self.stats["compiles"],
                "steady_compiles": self.stats["steady_compiles"],
                "n_prompt_buckets": len(self.cfg.prompt_buckets),
                "n_batch_buckets": len(self.cfg.batch_buckets),
                "programs": sorted(self._programs)}

    def audit_targets(self) -> Dict[str, Any]:
        """The decode program as an AuditTarget: one decode step over the
        slot table, recorded op by op (``repro_torch.audit.targets
        .serve_target``). The slot-table caches are the state whose storage
        must survive the step. Empty until the decode program exists; the
        recorded step is not counted in ``stats``."""
        from repro_torch.audit.targets import serve_target

        decode = self._programs.get("decode")
        if decode is None:
            return {}
        target, self._dstate = serve_target(
            "serve_decode", decode, self._store.params, self._dstate)
        return {"serve_decode": target}
