"""A JAX framework for physics-informed Gaussian-mixture PDE solving.

Built in JAX (XLA / Pallas / shard_map) with the capabilities of the reference
kr4b/pigs (see SURVEY.md): a differentiable Gaussian-mixture field evaluator with
analytic spatial derivatives up to third order, attention-based neighbor aggregation
over Gaussian primitives, adaptive splitting/pruning under static shapes, direct
("no-MLP") PDE solvers, and a PointNet-style dynamics-network training loop —
shardable over device meshes.  The accelerator is an NVIDIA GPU; tests run on
the CPU.

Layer map (a functional redesign of the reference's five layers, SURVEY.md §1):

  L0  pigs_tpu.ops       fused mixture evaluation + neighbor aggregation
                         (jnp oracle, blockwise XLA path, fused Pallas
                         kernels on the Triton route)
  L1  pigs_tpu.gaussians parameterization, covariance/conic construction, 2x2 eig
  L2  pigs_tpu.models    dynamics network + simulation state (padded, functional)
  L3  pigs_tpu.train     PN training loop, no-MLP solvers, fit-to-target init
  L4  tests/             pytest suite (the reference's manual scripts, made real)
  --  pigs_tpu.parallel  device-mesh sharding of samples x Gaussians (new; the
                         reference is single-GPU only, SURVEY.md §2 parallelism note)
"""

from pigs_tpu import gaussians
from pigs_tpu.pde import Problem, IntegrationRule, pde_rhs

__version__ = "0.1.0"

__all__ = [
    "gaussians",
    "Problem",
    "IntegrationRule",
    "pde_rhs",
    "__version__",
]
