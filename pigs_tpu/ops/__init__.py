"""Compute kernels: Gaussian-mixture field evaluation and neighbor aggregation.

The reference implements these as a stateful CUDA extension
(``diff_gaussian_sampling.GaussianSampler``, SURVEY.md §2.1).  Here they are pure
functions: the dense jnp oracle (``oracle``) is the correctness ground truth, the
blockwise XLA path (``mixture``) is the portable jit-able evaluator, and the fused
Pallas kernels (``pallas_mixture``, Triton route) are the GPU path.
"""

from pigs_tpu.ops.oracle import eval_mixture_dense, MixtureFields
from pigs_tpu.ops.mixture import eval_mixture
from pigs_tpu.ops.aggregate import aggregate_neighbors, neighbor_mask

__all__ = [
    "eval_mixture_dense",
    "eval_mixture",
    "MixtureFields",
    "aggregate_neighbors",
    "neighbor_mask",
]
