"""Device routing and launching for the hand-written CUDA kernels.

Routing is by the device the tensors lie on, and nothing else:

  * CPU tensors take the plain PyTorch twins (the tests' route).
  * CUDA tensors take the hand-written kernels, or raise. There is no
    switch that sends a CUDA tensor to a twin.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent, unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import functools

import torch

MAX_M = 32                                   # the kernels' register/smem cap
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # buffer dtype -> kernel code


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor is on a CUDA device, False when every one is
    on the CPU; anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"tensors on mixed or unsupported devices: {kinds}")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Asking for CUDA where there is
    none raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def launch(name: str, *args) -> None:
    """Call the launcher `name` of the kernel library (built on first use)
    with `args` and raise if it reports a CUDA error."""
    from repro_torch.kernels._build import library

    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The number of SMs of a CUDA device (grids are sized to it)."""
    index = torch.device(device).index
    return _sm_count(torch.cuda.current_device() if index is None else index)


def stream() -> int:
    """The current CUDA stream, as the launchers take it."""
    return torch.cuda.current_stream().cuda_stream


def vector_lanes(*tensors: torch.Tensor) -> bool:
    """True when every row of every tensor starts 16-byte aligned (its start
    and every stride of an axis longer than 1 before the lane axis) and the
    lane count is whole 16-byte units (4 fp32 or 8 bf16 lanes): a kernel
    then reads 16 bytes per row per step, else one lane."""
    for t in tensors:
        per = 16 // t.element_size()
        if t.shape[-1] % per or t.data_ptr() % 16:
            return False
        for size, st in zip(t.shape[:-1], t.stride()):
            if size > 1 and st % per:
                return False
    return True


def query_slot(x: torch.Tensor, q: torch.Tensor, axis: int = 0) -> int:
    """The slot j for which ``q`` is ``x.select(axis, j)`` in place (the
    same start and strides), else -1. A kernel then reads that row once,
    as the query and as row j."""
    off = q.data_ptr() - x.data_ptr()
    step = x.stride(axis) * x.element_size()
    if step <= 0 or off % step or not 0 <= off // step < x.shape[axis]:
        return -1
    shape, strides = list(x.shape), list(x.stride())
    del shape[axis], strides[axis]
    if list(q.shape) != shape:
        return -1
    for size, a, b in zip(shape, strides, q.stride()):
        if size > 1 and a != b:
            return -1
    return off // step


def grid_ctas(units: int, n_sys: int, sms: int, per_sm: int,
              threads: int) -> int:
    """CTAs per system for a pass that strides over each system's units: the
    card `per_sm` deep over all systems, and no more than one per `threads`
    units (a unit is the lanes one load covers)."""
    fill = -(-per_sm * sms // n_sys)
    return max(1, min(fill, -(-units // threads)))


_TICKETS: dict = {}


def tickets(device: torch.device, st: int, n: int) -> torch.Tensor:
    """At least `n` integer tickets, zero between launches: a kernel that
    picks its last CTA by a ticket resets the ticket itself. One buffer per
    (device, stream `st`), shared by every such kernel: launches on one
    stream run in order, so they never use it at the same time."""
    buf = _TICKETS.get((device, st))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
        _TICKETS[(device, st)] = buf
    return buf


def lanes_contiguous(t: torch.Tensor) -> bool:
    """Unit stride along the last (lane) axis, as every kernel reads it."""
    return t.shape[-1] == 1 or t.stride(-1) == 1


def check_flat_buffer(x: torch.Tensor) -> None:
    """Raise unless `x` is a per-leaf ring buffer the flat kernels take: an
    (m, S, n) float32/bfloat16 view with unit lane stride, 1 <= m <= MAX_M,
    1 <= S <= 65535 (the grid's y extent) and n < 2**31."""
    if x.dim() != 3 or x.dtype not in DTYPES:
        raise ValueError(f"buffer must be (m, S, n) float32/bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, n_sys, n = x.shape
    if not (1 <= m <= MAX_M and 1 <= n_sys <= 65535 and 1 <= n < 2 ** 31):
        raise ValueError(f"buffer shape {tuple(x.shape)}: need 1 <= m <= "
                         f"{MAX_M}, 1 <= S <= 65535 and 1 <= n < 2**31")
    if not lanes_contiguous(x):
        raise ValueError(f"buffer lanes must have unit stride, got strides "
                         f"{x.stride()}")
