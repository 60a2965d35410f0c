"""A numpy-seeded regression teacher (the reference benchmarks' own, copied
so both packages see the same rows): ``Y = tanh(X A1) * exp(-(X A2)^2 / 2)``
over 6 uniform inputs. The paper loop's and the Trainer's default rows on
the card (``chip_smoke.py`` phases 4-10); the paper's own PDE dataset is
``data/pollutant.py``."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_regression(seed: int = 0, n: int = 600, n_out: int = 400
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(X (n, 6), Y (n, n_out)) float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, 6)).astype(np.float32)
    A1 = rng.normal(size=(6, n_out)).astype(np.float32)
    A2 = rng.normal(size=(6, n_out)).astype(np.float32)
    Y = (np.tanh(X @ A1) * np.exp(-0.5 * (X @ A2) ** 2)).astype(np.float32)
    return X, Y
