from repro_torch.configs.base import (DMDConfig, DMDControllerConfig,
                                      OptimizerConfig)

__all__ = ["DMDConfig", "DMDControllerConfig", "OptimizerConfig"]
