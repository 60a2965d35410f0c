"""The paper's own experiment: softsign MLP 6 -> 40 -> 200 -> 1000 -> 2670
(2,882,150 fp32 parameters) predicting the pollutant concentration at 2670
points from 6 uncertain parameters (K12, K3, D, U0, uh, uv). The paper's
hyperparameters: Adam, 3000 epochs full-batch, classic DMD (eig mode,
unanchored, no guards) with m=14, s=55, tol=1e-10."""
from repro_torch.configs.base import (ArchConfig, DMDConfig, ModelConfig,
                                      OptimizerConfig, ParallelConfig,
                                      TrainConfig)

PAPER_SIZES = (6, 40, 200, 1000, 2670)


def get_config() -> ArchConfig:
    model = ModelConfig(name="pollutant-mlp", family="mlp", act="softsign")
    return ArchConfig(
        model=model,
        dmd=DMDConfig(m=14, s=55, tol=1e-10, warmup_steps=0,
                      cooldown_steps=0, anchor="none", affine=False,
                      trust_region=0.0, mode="eig", reset_opt_state=False,
                      snapshot_dtype="float32"),
        optimizer=OptimizerConfig(name="adam", lr=1e-3),
        parallel=ParallelConfig(),
        train=TrainConfig(steps=3000),
        shapes=())
