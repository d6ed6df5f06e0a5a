"""Simulation state: fixed-capacity padded Gaussian buffers with an active mask.

The reference mutates variable-length tensors — concatenating split Gaussians,
boolean-indexing out pruned ones, and performing Adam-state "surgery"
(model_pn.py:578-610, test_no_mlp.py:188-245).  Under XLA everything must be
static-shape, so this design (SURVEY.md §7 design stance) keeps every
per-Gaussian array at capacity ``N`` with an ``active`` mask:

  * prune    = clear mask bits (slots become free, contribute exactly 0 everywhere)
  * split    = write child parameters into free slots + set their mask bits
  * optimizer state lives in the same padded buffers, so "surgery" is just zeroing
    the moments of (re)allocated slots — exactly what the reference's cat/zeros
    dance achieves.

All functions are pure; the state is a NamedTuple pytree that jits, scans, shards
and checkpoints directly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from pigs_tpu import gaussians

__all__ = ["MixtureState", "init_state", "covariance_of", "prune", "split",
           "active_count", "compact_scatter"]


class MixtureState(NamedTuple):
    """Padded Gaussian mixture state.

    ``scaling`` holds *positive variances* (post-exp), and ``transforms`` the raw
    off-diagonal parameters, matching the reference Model's storage convention
    (model_pn.py:344-348, 685).  Boundary Gaussians occupy the first
    ``n_boundary`` slots, mirroring the reference's concatenation order
    (model_pn.py:530-537).
    """

    means: jax.Array        # (N, d)
    scaling: jax.Array      # (N, d)      positive variances
    transforms: jax.Array   # (N, T)      raw off-diagonals, T = d*(d-1)//2
    u: jax.Array            # (N, c)      per-Gaussian values
    active: jax.Array       # (N,)        bool: slot occupied
    boundary: jax.Array     # (N,)        bool: fixed boundary Gaussian

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def d(self) -> int:
        return self.means.shape[1]

    @property
    def c(self) -> int:
        return self.u.shape[1]

    @property
    def interior(self) -> jax.Array:
        """Active non-boundary slots — the reference's ``boundary_mask``
        (model_pn.py:519)."""
        return self.active & ~self.boundary


def init_state(
    capacity: int,
    means: jax.Array,
    scaling: jax.Array,
    transforms: jax.Array,
    u: jax.Array,
    boundary_means: Optional[jax.Array] = None,
    boundary_scaling: Optional[jax.Array] = None,
    boundary_transforms: Optional[jax.Array] = None,
    boundary_u: Optional[jax.Array] = None,
) -> MixtureState:
    """Build a padded state from concrete interior (+ optional boundary) params.

    Boundary Gaussians come first (reference order, model_pn.py:530-537), then the
    interior, then inactive free slots up to ``capacity``.
    """
    parts_means, parts_scaling, parts_transforms, parts_u = [], [], [], []
    n_boundary = 0
    if boundary_means is not None and boundary_means.shape[0] > 0:
        n_boundary = boundary_means.shape[0]
        parts_means.append(boundary_means)
        parts_scaling.append(boundary_scaling)
        parts_transforms.append(boundary_transforms)
        parts_u.append(boundary_u)
    parts_means.append(means)
    parts_scaling.append(scaling)
    parts_transforms.append(transforms)
    parts_u.append(u)

    cat_means = jnp.concatenate(parts_means, axis=0)
    cat_scaling = jnp.concatenate(parts_scaling, axis=0)
    cat_transforms = jnp.concatenate(parts_transforms, axis=0)
    cat_u = jnp.concatenate(parts_u, axis=0)
    n = cat_means.shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial Gaussian count {n}")

    pad = capacity - n

    def pad0(x):
        return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))

    active = jnp.arange(capacity) < n
    boundary = jnp.arange(capacity) < n_boundary
    # Inactive scaling must stay positive so conic construction is finite.
    scaling_padded = jnp.where(
        active[:, None], pad0(cat_scaling),
        jnp.ones((capacity, means.shape[1]), cat_scaling.dtype))
    return MixtureState(
        means=pad0(cat_means),
        scaling=scaling_padded,
        transforms=pad0(cat_transforms),
        u=pad0(cat_u),
        active=active,
        boundary=boundary,
    )


def covariance_of(state: MixtureState) -> Tuple[jax.Array, jax.Array]:
    """Full ``(N, d, d)`` covariances and conics of the current state."""
    return gaussians.build_full_covariances(state.scaling, state.transforms)


def active_count(state: MixtureState) -> jax.Array:
    return jnp.sum(state.active)


def prune(state: MixtureState, keep: jax.Array) -> MixtureState:
    """Deactivate interior slots where ``keep`` is False (boundaries are kept,
    like the reference's ``keep_indices`` union with boundaries,
    model_pn.py:703-714)."""
    new_active = state.active & (keep | state.boundary)
    return state._replace(active=new_active)


def compact_scatter(free_slots: jax.Array, want: jax.Array) -> jax.Array:
    """Assign the k-th True of ``want`` to the k-th True of ``free_slots``.

    Returns an ``(N,)`` int32 array: for each wanting index, the destination slot
    index; for others, ``N`` (out of range, dropped by scatter mode='drop').
    """
    n = free_slots.shape[0]
    free_idx = jnp.nonzero(free_slots, size=n, fill_value=n)[0]  # k-th free slot
    want_rank = jnp.cumsum(want.astype(jnp.int32)) - 1           # rank among wants
    dest = jnp.where(want, free_idx[jnp.clip(want_rank, 0, n - 1)], n)
    # Wants beyond the number of free slots map to n (dropped).
    return dest


def split(
    state: MixtureState,
    indices: jax.Array,
    split_scale: float = 1.0,
) -> MixtureState:
    """Split the flagged Gaussians along their principal covariance axis.

    Functional equivalent of ``Model.split`` (model_pn.py:578-610): each flagged
    Gaussian is replaced by two copies displaced by +-(|lambda_max| * v_max) with
    halved values.  The first child overwrites the parent slot; the second child is
    scattered into a free slot (if capacity allows — splits beyond capacity are
    dropped, preserving static shapes).  The 2x2 eigendecomposition is closed form
    (no ``torch.linalg.eig``).
    """
    want = indices & state.interior
    cov, _ = covariance_of(state)
    if state.d == 2:
        axis = gaussians.principal_axis(cov)              # (N, d)
    elif state.d == 1:
        axis = cov[..., 0]
    else:
        raise ValueError(f"split supports d in {{1,2}}, got {state.d}")
    axis = axis * split_scale

    half_u = jnp.where(want[:, None], state.u * 0.5, state.u)
    parent_means = jnp.where(want[:, None], state.means - axis, state.means)

    dest = compact_scatter(~state.active, want)
    child_means = state.means + axis

    def scatter_rows(buf, rows):
        return buf.at[dest].set(rows, mode="drop")

    new_means = scatter_rows(parent_means, child_means)
    new_scaling = scatter_rows(state.scaling, state.scaling)
    new_transforms = scatter_rows(state.transforms, state.transforms)
    new_u = scatter_rows(half_u, half_u)
    landed = jnp.zeros_like(state.active).at[dest].set(want, mode="drop")
    new_active = state.active | landed
    return state._replace(
        means=new_means, scaling=new_scaling, transforms=new_transforms,
        u=new_u, active=new_active)
