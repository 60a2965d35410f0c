"""Training state."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

PyTree = Any


class TrainState(NamedTuple):
    params: PyTree
    opt_state: PyTree
    step: torch.Tensor         # 0-dim int32 on the training device: the
                               # optimizer-step counter the lr schedule and
                               # the bias corrections read, advanced inside
                               # the (captured) train step
    dmd_buffers: PyTree        # snapshot buffers (None when DMD is off)
    dmd_gram: PyTree = None    # streaming (n_sys, m, m) fp32 Grams (None
                               # unless dmd.streaming_gram)
    controller: PyTree = None  # per-group ControllerState of (n_groups,)
                               # tensors (None unless the controller is on)
