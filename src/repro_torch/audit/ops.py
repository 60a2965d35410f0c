"""The op recorder: what one eager call ran, op by op.

The reference audits the traced jaxpr and the compiled HLO of each step.
The port runs its steps eagerly, so its audit runs a step once and
records it instead: ``record(fn, *args, **kwargs)`` calls `fn` under a
``TorchDispatchMode`` and returns its output and a ``Recording`` of

  * every aten op that is not a view, with its inputs' and outputs'
    shapes, dtypes and storage pointers;
  * each hand-written kernel as ONE opaque op (``kernel.<name>``): every
    kernel wrapper is ``kernels.device.opaque``, so a kernel call and its
    ``*_ref`` twin on the CPU record alike, as a ``pallas_call`` is one
    equation of the reference's jaxpr. The span's own tensor work (the
    twin's ops, the per-tile upcasts, the output allocations) is not
    recorded; a host sync inside it marks the span;
  * the DMD solve's host steps the same way (``host.eigh``, ``host.eig``:
    ``core/dmd.py``);
  * the kernels' launches: the wrappers' ``LAUNCHES`` counters, before
    and after the call (zero on the CPU, where the twins run);
  * host syncs: ``aten._local_scalar_dense`` (``.item()``, ``int``/``bool``
    of a tensor), the ops whose output shape depends on the data
    (``nonzero`` and kin), and copies from a CUDA tensor to the CPU;
  * transfers: copies between devices, kept out of the op count (host
    data landing on the card has no counterpart on the CPU);
  * c10d collectives.

``Recording.count`` (ops and opaque spans, transfers apart) does not
depend on the device for the same build: the port's device branches all
sit inside opaque spans.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import device as kdevice

# torch dtype -> the reference's HLO spelling (shape strings compare
# across the packages)
SHORT_DTYPE = {torch.float64: "f64", torch.float32: "f32",
               torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred",
               torch.complex64: "c64", torch.complex128: "c128"}
DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
               "s16": 2, "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16}

# aten ops that read a device value back to the host: a scalar read, and
# the ops whose output size depends on the data (the card must finish
# them before the host can size the result)
SYNC_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2",
            "unique_dim", "unique_consecutive")
COPY_OPS = ("_to_copy", "copy_", "copy")
COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def short_dtype(dtype: torch.dtype) -> str:
    return SHORT_DTYPE.get(dtype, str(dtype).removeprefix("torch."))


def shape_str(t: torch.Tensor) -> str:
    """A tensor's shape string as the reference's HLO spells it
    (``f32[4,2,32]``)."""
    return f"{short_dtype(t.dtype)}[{','.join(str(int(d)) for d in t.shape)}]"


def shape_str_of(dtype_name: str, shape) -> str:
    """``shape_str`` of a tensor described by its dtype name and shape (a
    collective's record, ``launch/mesh.py``)."""
    return (f"{short_dtype(getattr(torch, dtype_name))}"
            f"[{','.join(str(int(d)) for d in shape)}]")


def shape_bytes(s: str) -> int:
    """Bytes of one shape string (0 if unparsable)."""
    dt, _, dims = s.partition("[")
    n = 1
    for d in dims.rstrip("]").split(","):
        if d:
            n *= int(d)
    return n * DTYPE_BYTES.get(dt, 4)


@dataclass(frozen=True)
class TensorMeta:
    shape: str                  # shape string, "f32[4,2,32]"
    storage: int                # untyped storage's data pointer

    @property
    def dtype(self) -> str:
        return self.shape.split("[", 1)[0]


@dataclass(frozen=True)
class Op:
    name: str                   # "aten.mm.default", "kernel.gram_row", ...
    kind: str                   # aten | kernel | host | transfer | collective
    inputs: Tuple[TensorMeta, ...]
    outputs: Tuple[TensorMeta, ...]
    sync: bool = False          # reads (or holds a read of) a device value

    @property
    def fresh_outputs(self) -> Tuple[TensorMeta, ...]:
        """Outputs in storage none of the op's inputs owns: new tensors."""
        held = {m.storage for m in self.inputs}
        return tuple(m for m in self.outputs if m.storage not in held)


@dataclass
class Recording:
    ops: List[Op] = field(default_factory=list)
    launches: Dict[str, int] = field(default_factory=dict)

    @property
    def counted(self) -> List[Op]:
        """The device-independent ops: everything but transfers."""
        return [o for o in self.ops if o.kind != "transfer"]

    @property
    def count(self) -> int:
        return len(self.counted)

    @property
    def kernel_calls(self) -> List[Op]:
        return [o for o in self.ops if o.kind == "kernel"]

    @property
    def syncs(self) -> List[Op]:
        return [o for o in self.ops if o.sync]

    @property
    def collectives(self) -> List[Op]:
        return [o for o in self.ops if o.kind == "collective"]


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _meta(t: torch.Tensor) -> TensorMeta:
    try:
        ptr = t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        ptr = 0
    return TensorMeta(shape_str(t), ptr)


def _metas(*xs) -> Tuple[TensorMeta, ...]:
    return tuple(_meta(t) for x in xs for t in _tensors(x))


def launch_counters() -> Dict[str, int]:
    """Every kernel wrapper's launch counters, by name (the design and
    backward counters included)."""
    from repro_torch.kernels import arena, combine, flash_attention, gram
    from repro_torch.kernels import gram_row

    out: Dict[str, int] = {}
    for counter in (arena.LAUNCHES, arena.BWD_LAUNCHES, gram_row.LAUNCHES,
                    gram_row.BWD_LAUNCHES, combine.LAUNCHES, gram.LAUNCHES,
                    flash_attention.LAUNCHES):
        out.update(counter)
    return out


class _Recorder(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops: List[Op] = []
        self._depth = 0             # > 0 inside an opaque span
        self._span_sync = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = func.overloadpacket.__name__
        src = dst = None
        if op in ("copy_", "copy"):
            dst, src = args[0], args[1]
        elif op in COPY_OPS and isinstance(out, torch.Tensor):
            src, dst = args[0], out
        transfer = (isinstance(src, torch.Tensor) and isinstance(
            dst, torch.Tensor) and src.device.type != dst.device.type)
        # the data-dependent ops count as syncs on either device (the
        # card syncs on them); a copy to the host only on the card
        sync = op in SYNC_OPS or (transfer and src.device.type == "cuda"
                                  and dst.device.type == "cpu")
        if self._depth:
            self._span_sync = self._span_sync or sync
            return out
        if func.is_view:
            return out
        ns = func.namespace
        if ns in COLLECTIVE_NAMESPACES:
            kind = "collective"
        elif transfer:
            kind = "transfer"
        else:
            kind = "aten"
        self.ops.append(Op(
            name=f"{ns}.{op}.{func._overloadname}", kind=kind,
            inputs=_metas(args, kwargs), outputs=_metas(out), sync=sync))
        return out

    def span(self, name: str, kind: str, fn: Callable, args, kwargs):
        if self._depth:
            return fn(*args, **kwargs)
        ins = _metas(args, kwargs)
        self._depth += 1
        self._span_sync = False
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        self.ops.append(Op(name=f"{kind}.{name}", kind=kind, inputs=ins,
                           outputs=_metas(out), sync=self._span_sync))
        return out


def record(fn: Callable, *args, **kwargs) -> Tuple[Any, Recording]:
    """Run ``fn(*args, **kwargs)`` once, recorded. Returns (its output, the
    Recording)."""
    rec = _Recorder()
    before = launch_counters()
    prev = kdevice.set_span_hook(rec.span)
    if prev is not None:
        kdevice.set_span_hook(prev)
        raise RuntimeError("an op recording is already running")
    try:
        with rec:
            out = fn(*args, **kwargs)
    finally:
        kdevice.set_span_hook(None)
    after = launch_counters()
    delta = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    return out, Recording(rec.ops, delta)
