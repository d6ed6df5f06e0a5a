"""Sharded Gaussian-mixture evaluation over a device mesh.

The all-pairs (samples x Gaussians) reduction shards along both axes
(SURVEY.md §5 "long-context" note): query points split over the ``data`` axis,
Gaussians split over the ``model`` axis.  Each device computes the partial sum of
its Gaussian shard at its sample shard; a single ``psum`` over the ``model`` axis
completes the mixture sum.  Gradients flow through ``shard_map`` + ``psum``
automatically (psum transposes to identity for replicated cotangents).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from pigs_tpu.ops.mixture import eval_mixture
from pigs_tpu.ops.oracle import MixtureFields, eval_mixture_dense
from pigs_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

__all__ = ["eval_mixture_sharded", "eval_mixture_ring"]


def eval_mixture_sharded(
    mesh: Mesh,
    means: jax.Array,
    conics: jax.Array,
    values: jax.Array,
    samples: jax.Array,
    order: int = 0,
    mask: Optional[jax.Array] = None,
    period: Optional[float] = None,
    impl: str = "auto",
    interpret: bool = False,
) -> MixtureFields:
    """Mixture evaluation with samples sharded over ``data`` and Gaussians over
    ``model``.  Array sizes must divide the respective mesh axis sizes.

    ``impl`` and ``interpret`` select the per-device path exactly like
    :func:`pigs_tpu.ops.mixture.eval_mixture` — "auto" runs the fused kernels
    on each device's local shard inside ``shard_map`` on a GPU.

    Returns fields sharded over the ``data`` axis (replicated over ``model``).
    """
    if mask is None:
        mask = jnp.ones(means.shape[0], bool)

    n_orders = order + 1

    def local(means, conics, values, mask, samples):
        out = eval_mixture(means, conics, values, samples, order=order,
                           mask=mask, period=period, impl=impl,
                           diff_samples=False, interpret=interpret)
        partial_fields = tuple(f for f in out[:n_orders])
        return tuple(jax.lax.psum(f, MODEL_AXIS) for f in partial_fields)

    gauss_spec = P(MODEL_AXIS)
    # check_vma=False: pallas_call cannot declare varying-mesh-axes metadata
    # yet, and the psum above already makes the outputs replicated over
    # MODEL_AXIS by construction.
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(gauss_spec, gauss_spec, gauss_spec, gauss_spec, P(DATA_AXIS)),
        out_specs=tuple(P(DATA_AXIS) for _ in range(n_orders)),
        check_vma=False,
    )
    fields = fn(means, conics, values, mask, samples)
    return MixtureFields(*(list(fields) + [None] * (4 - n_orders)))


def eval_mixture_ring(
    mesh: Mesh,
    means: jax.Array,
    conics: jax.Array,
    values: jax.Array,
    samples: jax.Array,
    order: int = 0,
    mask: Optional[jax.Array] = None,
    period: Optional[float] = None,
    impl: str = "auto",
    interpret: bool = False,
) -> MixtureFields:
    """Ring-accumulation mixture evaluation for Gaussian counts too large to
    replicate: Gaussians stay sharded over the ``model`` axis; each device
    evaluates the resident shard against its sample shard, then the Gaussian
    shards rotate around the ring via ``ppermute`` (neighbor exchange)
    until every device has seen every shard (SURVEY.md §5 "long-context"
    note: blockwise streaming instead of an all-gather).

    Peak per-device memory is O(local Gaussians + local samples); communication
    is the same volume as an all-gather but overlapped with compute by XLA's
    latency hiding.
    """
    if mask is None:
        mask = jnp.ones(means.shape[0], bool)

    n_orders = order + 1
    axis_size = mesh.shape[MODEL_AXIS]

    def local(means, conics, values, mask, samples):
        perm = [(i, (i + 1) % axis_size) for i in range(axis_size)]

        def rotate(x):
            return jax.lax.ppermute(x, MODEL_AXIS, perm)

        def body(carry, _):
            (means, conics, values, mask), acc = carry
            out = eval_mixture(means, conics, values, samples, order=order,
                               mask=mask, period=period, impl=impl,
                               diff_samples=False, interpret=interpret)
            acc = tuple(a + f for a, f in zip(acc, out[:n_orders]))
            shard = jax.tree_util.tree_map(rotate,
                                           (means, conics, values, mask))
            return (shard, acc), None

        out0 = eval_mixture(means, conics, values, samples, order=order,
                            mask=mask, period=period, impl=impl,
                            diff_samples=False, interpret=interpret)
        zeros = tuple(jnp.zeros_like(f) for f in out0[:n_orders])
        (_, acc), _ = jax.lax.scan(
            body, ((means, conics, values, mask), zeros), None,
            length=axis_size)
        return acc

    gauss_spec = P(MODEL_AXIS)
    # After a full ring rotation every device holds the complete sum; shard_map
    # cannot infer that replication statically (check_vma=False).
    fn = shard_map(
        local, mesh=mesh,
        in_specs=(gauss_spec, gauss_spec, gauss_spec, gauss_spec, P(DATA_AXIS)),
        out_specs=tuple(P(DATA_AXIS) for _ in range(n_orders)),
        check_vma=False,
    )
    fields = fn(means, conics, values, mask, samples)
    return MixtureFields(*(list(fields) + [None] * (4 - n_orders)))
