"""Data-parallel PN training step: collocation samples sharded over the mesh,
network parameters replicated, gradients all-reduced across devices.

The reference has no distributed training (SURVEY.md §2.2); this is the
additive design: each device computes the physics losses on its
sample shard, gradients are ``pmean``-ed over the ``data`` axis (XLA lowers to
an all-reduce overlapped with the backward where possible), and one
replicated Adam update is applied.  Per-sample losses are means over equal
shards, so ``pmean`` of local means equals the global mean.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from pigs_tpu.models.model import ModelConfig, compute_loss, forward_step, \
    sample_fields
from pigs_tpu.parallel.mesh import DATA_AXIS

__all__ = ["make_dp_train_step"]


def make_dp_train_step(mesh: Mesh, cfg: ModelConfig, network, opt):
    """Build a jitted data-parallel training step.

    Returns ``step(params, opt_state, state, prev_fields, samples,
    time_samples, bc_samples, lr_scale, t, dt) -> (params, opt_state,
    new_state, curr_fields, total_loss)`` with ``samples``/``time_samples``/
    ``bc_samples`` sharded along the ``data`` axis and everything else
    replicated.
    """

    def local_step(params, opt_state, state, prev_fields, samples,
                   time_samples, bc_samples, lr_scale, t, dt):
        def loss_fn(p):
            new_state, deltas = forward_step(cfg, network, p, state, t=t)
            curr = sample_fields(cfg, new_state, samples, bc_samples)
            losses = compute_loss(cfg, new_state, deltas, prev_fields, curr,
                                  samples, time_samples, t, dt)
            return losses.total, (new_state, curr)

        (loss, (new_state, curr)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        # Gradient all-reduce over the data axis.
        grads = jax.lax.pmean(grads, DATA_AXIS)
        loss = jax.lax.pmean(loss, DATA_AXIS)

        opt_state.hyperparams["learning_rate"] = lr_scale
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        new_state = jax.tree_util.tree_map(jax.lax.stop_gradient, new_state)
        curr = jax.tree_util.tree_map(
            lambda x: None if x is None else jax.lax.stop_gradient(x), curr,
            is_leaf=lambda x: x is None)
        return params, opt_state, new_state, curr, loss

    data = P(DATA_AXIS)
    rep = P()
    # prev_fields and the returned curr fields are per-sample data: sharded.
    sharded = shard_map(
        local_step, mesh=mesh,
        in_specs=(rep, rep, rep, data, data, data, data, rep, rep, rep),
        out_specs=(rep, rep, rep, data, rep),
        check_vma=False,
    )
    return jax.jit(sharded)
