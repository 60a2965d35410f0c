"""Lane tiling and device routing for the DMD data-pass kernels.

Routing is by the device the tensors lie on, and nothing else:

  * CPU tensors take the plain PyTorch twins (the tests' route).
  * CUDA tensors take the hand-written kernels, or raise. There is no
    switch that sends a CUDA tensor to a twin.

Entry points take an explicit ``device`` (default ``"cuda"``) and raise
when CUDA is absent, unless the caller asks for ``"cpu"``.
"""
from __future__ import annotations

import torch

LANES = 128                       # lane quantum of the arena layout


def lane_block(block_n: int, n: int) -> int:
    """Clamp the requested n-tile to the leaf: a 128-lane multiple no wider
    than the lane-padded leaf itself (tiny leaves get one 128-lane tile).
    Zero pad lanes contribute zero to every inner product, so padding is
    exact."""
    n_pad = max(-(-max(n, 1) // LANES) * LANES, LANES)
    return max(min(block_n // LANES * LANES, n_pad), LANES)


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
