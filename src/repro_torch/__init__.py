"""PyTorch/CUDA port of the DMD-accelerated training system.

A second package beside the JAX reference ``repro``: it keeps the
reference's module names so each counterpart is easy to find, imports
``torch`` and never ``jax`` or ``repro``, and runs its DMD data passes
through hand-written Hopper kernels (``kernels/csrc/arena.cu``).

TF32 is switched off here, once, for the whole process: the anchored Gram
is conditioned at the fp32 noise floor (``DMDConfig.tol = 1e-4``,
DESIGN.md §2.1), and a TF32 matmul keeps only about three decimal digits.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
