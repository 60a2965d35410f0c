"""Continuous-batching serving of the dense LM (``engine``) over a
double-buffered, version-stamped weight store and the trainer -> server
weights channel (``store``)."""
from repro_torch.serve.engine import (Request, Result, ServeConfig,
                                      ServeEngine)
from repro_torch.serve.store import ParamStore, WeightsChannel

__all__ = ["ParamStore", "Request", "Result", "ServeConfig", "ServeEngine",
           "WeightsChannel"]
