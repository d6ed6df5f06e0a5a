"""Attention-based neighbor aggregation over Gaussian primitives.

Static-shape redesign of the reference's ``preprocess_aggregate`` /
``aggregate_neighbors`` CUDA methods (call sites: model_pn.py:253-264,
test_neighbor_aggregation.py:89-98; contract reconstructed in SURVEY.md §2.1).  The
CUDA extension builds an irregular neighbor list of overlapping Gaussians; here
the same computation is a dense masked attention over all pairs — static shapes,
elementwise work and matrix products that XLA fuses — with the neighborhood
expressed as a boolean mask derived from a
Gaussian-overlap radius test.

Semantics (per Gaussian i over neighbors j):

  pe(r)    in R^E   : sinusoidal embedding of the displacement r = mu_j - mu_i,
                      [1, sin(f_k r_a), cos(f_k r_a)]  (E = 1 + 2*F*d)
  emb(r)   in R^2E  : [pe(r), pe(2r)] — two frequency octaves
  logits_ij         = <q_i, k_j> / sqrt(K)
  alpha_ij          = masked softmax_j(logits_ij)        (i's overlapping neighbors)
  msg_ij   in R^L   = (W_t f_j) * (W_d emb(r_ij))        (feature map gated by a
                                                          learned distance filter)
  out_i    in R^L   = sum_j alpha_ij msg_ij

Differentiable w.r.t. all six tensor inputs (features, transform, queries, keys,
frequencies, distance_transform) — the property the reference verifies with its one
active float64 gradcheck (test_neighbor_aggregation.py:89-98); ours is verified with
``jax.test_util.check_grads`` in tests/test_aggregate.py.  Shape contract matches
the reference: features (n, L), transform (L, L), queries/keys (n, K),
frequencies (F,), distance_transform (L, 2E), output (n, L).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from pigs_tpu.ops.matmul import matmul

__all__ = ["positional_embedding", "neighbor_mask", "aggregate_neighbors",
           "aggregate_neighbors_factored"]


def positional_embedding(rel: jax.Array, frequencies: jax.Array) -> jax.Array:
    """Sinusoidal embedding of displacements: ``(..., d) -> (..., 1 + 2*F*d)``."""
    phases = rel[..., None, :] * frequencies[..., :, None]  # (..., F, d)
    flat = phases.reshape(*phases.shape[:-2], -1)           # (..., F*d)
    const = jnp.ones((*rel.shape[:-1], 1), dtype=rel.dtype)
    return jnp.concatenate([const, jnp.sin(flat), jnp.cos(flat)], axis=-1)


def neighbor_mask(
    means: jax.Array,
    covariances: jax.Array,
    active: Optional[jax.Array] = None,
    sigma_cut: float = 3.0,
    period: Optional[float] = None,
    include_self: bool = False,
) -> jax.Array:
    """Boolean ``(n, n)`` mask of overlapping Gaussian pairs.

    Pair (i, j) are neighbors when their centers are within
    ``sigma_cut * (r_i + r_j)`` where ``r = sqrt(max diag(Sigma))`` approximates the
    principal standard deviation — the dense-mask equivalent of the CUDA kernel's
    overlapping-pair neighbor structure (SURVEY.md §2.1 ``preprocess_aggregate``).
    """
    n, d = means.shape
    rel = means[None, :, :] - means[:, None, :]
    if period is not None:
        rel = rel - period * jnp.round(rel / period)
    dist = jnp.linalg.norm(rel, axis=-1)
    radius = jnp.sqrt(jnp.max(jnp.diagonal(covariances, axis1=-2, axis2=-1), axis=-1))
    cut = sigma_cut * (radius[:, None] + radius[None, :])
    mask = dist <= cut
    if not include_self:
        mask = mask & ~jnp.eye(n, dtype=bool)
    if active is not None:
        mask = mask & active[None, :] & active[:, None]
    return mask


@partial(jax.jit, static_argnames=("period",))
def aggregate_neighbors(
    features: jax.Array,
    transform: jax.Array,
    queries: jax.Array,
    keys: jax.Array,
    frequencies: jax.Array,
    distance_transform: jax.Array,
    means: jax.Array,
    mask: jax.Array,
    period: Optional[float] = None,
) -> jax.Array:
    """Aggregate neighbor features with distance-gated masked attention.

    Args:
      features: ``(n, L)`` per-Gaussian latent features.
      transform: ``(L, L)`` learned feature map applied to neighbor features.
      queries / keys: ``(n, K)`` attention projections.
      frequencies: ``(F,)`` sinusoidal embedding frequencies (fixed in the
        reference, model_pn.py:227-230, but differentiable here).
      distance_transform: ``(L, 2E)`` learned filter over the displacement
        embedding, ``E = 1 + 2*F*d``.
      means: ``(n, d)`` Gaussian centers (for relative displacements).
      mask: ``(n, n)`` boolean neighborhood from :func:`neighbor_mask`.
      period: optional torus period for displacement wrapping.

    Returns:
      ``(n, L)`` aggregated neighbor features.  Rows with no neighbors are zero.
    """
    n, L = features.shape
    K = queries.shape[-1]
    rel = means[None, :, :] - means[:, None, :]             # (n, n, d): mu_j - mu_i
    if period is not None:
        rel = rel - period * jnp.round(rel / period)

    pe1 = positional_embedding(rel, frequencies)            # (n, n, E)
    pe2 = positional_embedding(2.0 * rel, frequencies)      # (n, n, E)
    emb = jnp.concatenate([pe1, pe2], axis=-1)              # (n, n, 2E)

    logits = (queries @ keys.T) / jnp.sqrt(jnp.asarray(K, features.dtype))
    neg = jnp.asarray(jnp.finfo(features.dtype).min, features.dtype)
    logits = jnp.where(mask, logits, neg)
    # Masked softmax that yields exactly zero rows when a Gaussian has no neighbors.
    logits_max = jnp.max(logits, axis=-1, keepdims=True)
    unnorm = jnp.exp(logits - jax.lax.stop_gradient(logits_max)) * mask
    denom = jnp.sum(unnorm, axis=-1, keepdims=True)
    alpha = unnorm / jnp.maximum(denom, jnp.asarray(1e-30, features.dtype))

    mapped = features @ transform.T                         # (n, L): W_t f_j
    gate = jnp.einsum("ijE,lE->ijl", emb, distance_transform)  # (n, n, L)
    # out_i = sum_j alpha_ij * mapped_j * gate_ij
    return jnp.einsum("ij,jl,ijl->il", alpha, mapped, gate)


# ------------------------------------------------------------------ factored --
#
# The speed-of-light formulation.  Every embedding component depends on ONE
# displacement coordinate, so the angle-addition identities
#     sin(f (a_j - a_i)) = s_j c_i - c_j s_i,   cos(f (a_j - a_i)) = c_j c_i + s_j s_i
# factor the whole (n, n, 2E) embedding tensor into rank-1 products of
# per-Gaussian trig tables.  The gated aggregation then collapses to plain
# matmuls:
#
#     out[i,l] = sum_t U[i,t] * Dmap[l,t] * C[i,l,t],
#     C = alpha @ (V [*] mapped)        (one (n,n) x (n, L*T) matmul)
#
# with T = 2 + 8*F*d table columns (4 trig products per (octave, freq, axis)
# plus one constant per octave).  No per-pair transcendentals, no O(n^2 * 2E)
# elementwise work, no Pallas required — XLA hands the products to its matrix
# kernels and
# differentiates it (including twice) natively.  Periodic domains add a
# per-axis wrap count m = round(rel/period) in {-1,0,1}; the wrap is a
# k-independent phase shift, handled by 3 masked copies of alpha per axis with
# phase-rotated Dmap coefficients.


def _trig_tables(means: jax.Array, frequencies: jax.Array):
    """Per-Gaussian sin/cos tables for both octaves: returns (s, c), each
    (2, n, F, d) with s[p-1, i, k, a] = sin(p * f_k * means[i, a])."""
    phases = means[None, :, None, :] * frequencies[None, None, :, None]
    phases = phases * jnp.asarray([1.0, 2.0],
                                  means.dtype)[:, None, None, None]
    return jnp.sin(phases), jnp.cos(phases)


def _axis_dmaps(distance_transform: jax.Array, F: int, d: int, dtype):
    """Split the (L, 2E) distance transform into per-(octave, axis) sin/cos
    blocks: returns (dsin, dcos), each (2, d, L, F), plus dconst (L,) — the
    sum of both octaves' constant columns."""
    L = distance_transform.shape[0]
    E = 1 + 2 * F * d
    dsin = jnp.zeros((2, d, L, F), dtype)
    dcos = jnp.zeros((2, d, L, F), dtype)
    for p in range(2):
        off = p * E
        # dense layout: flat index k*d + a (positional_embedding)
        s_block = distance_transform[:, off + 1:off + 1 + F * d]
        c_block = distance_transform[:, off + 1 + F * d:off + 1 + 2 * F * d]
        s_block = s_block.reshape(L, F, d)
        c_block = c_block.reshape(L, F, d)
        dsin = dsin.at[p].set(jnp.moveaxis(s_block, -1, 0))
        dcos = dcos.at[p].set(jnp.moveaxis(c_block, -1, 0))
    dconst = distance_transform[:, 0] + distance_transform[:, E]
    return dsin, dcos, dconst


def _masked_softmax(queries, keys, mask, dtype, bf16):
    K = queries.shape[-1]
    logits = matmul(queries, keys.T, bf16) / jnp.sqrt(jnp.asarray(K, dtype))
    neg = jnp.asarray(jnp.finfo(dtype).min, dtype)
    logits = jnp.where(mask, logits, neg)
    logits_max = jnp.max(logits, axis=-1, keepdims=True)
    unnorm = jnp.exp(logits - jax.lax.stop_gradient(logits_max)) * mask
    denom = jnp.sum(unnorm, axis=-1, keepdims=True)
    return unnorm / jnp.maximum(denom, jnp.asarray(1e-30, dtype))


@partial(jax.jit, static_argnames=("period", "bf16_products"))
def aggregate_neighbors_factored(
    features: jax.Array,
    transform: jax.Array,
    queries: jax.Array,
    keys: jax.Array,
    frequencies: jax.Array,
    distance_transform: jax.Array,
    means: jax.Array,
    mask: jax.Array,
    period: Optional[float] = None,
    bf16_products: bool = False,
) -> jax.Array:
    """Exact :func:`aggregate_neighbors` semantics via the angle-addition
    factorization — O(n^2) work all in matrix products instead of O(n^2 * 2E)
    elementwise.  Same signature, any d, differentiable in all inputs (plain
    XLA autodiff, to any order).  The matrix products are exact
    (``HIGHEST``), or one bfloat16 pass with ``bf16_products``
    (:func:`pigs_tpu.ops.matmul.matmul`; reverse mode only).
    """
    n, L = features.shape
    d = means.shape[-1]
    F = frequencies.shape[0]
    dtype = features.dtype

    mm = partial(matmul, bf16=bf16_products)
    alpha = _masked_softmax(queries, keys, mask, dtype, bf16_products)
    mapped = mm(features, transform.T)                     # (n, L)
    s, c = _trig_tables(means, frequencies)                # (2, n, F, d)
    dsin, dcos, dconst = _axis_dmaps(distance_transform, F, d, dtype)

    # Constant components: gate contribution independent of the pair.
    out = mm(alpha, mapped) * dconst[None, :]

    if period is None:
        m_counts = None
    else:
        rel = means[None, :, :] - means[:, None, :]        # (n, n, d)
        m_counts = jnp.clip(jnp.round(rel / period), -1.0, 1.0)

    for a in range(d):
        # Tables for this axis, both octaves: (n, 2F)
        s_a = jnp.concatenate([s[0, :, :, a], s[1, :, :, a]], axis=-1)
        c_a = jnp.concatenate([c[0, :, :, a], c[1, :, :, a]], axis=-1)
        # 4 trig products per (octave, freq): U-side and V-side factors.
        U = jnp.concatenate([c_a, s_a, c_a, s_a], axis=-1)  # (n, 8F)
        V = jnp.concatenate([s_a, c_a, c_a, s_a], axis=-1)
        T = 8 * F
        # V [*] mapped -> (n, L*T) then one matmul with (masked) alpha.
        VM = (V[:, None, :] * mapped[:, :, None]).reshape(n, L * T)

        ds_a = jnp.concatenate([dsin[0, a], dsin[1, a]], axis=-1)  # (L, 2F)
        dc_a = jnp.concatenate([dcos[0, a], dcos[1, a]], axis=-1)

        if m_counts is None:
            shifts = [(None, alpha)]
        else:
            shifts = [(mval, alpha * (m_counts[:, :, a] == mval))
                      for mval in (-1.0, 0.0, 1.0)]

        for mval, alpha_m in shifts:
            if mval is None or mval == 0.0:
                # Dmap columns: [ +dsin, -dsin, +dcos, +dcos ]
                Dmap = jnp.concatenate([ds_a, -ds_a, dc_a, dc_a], axis=-1)
            else:
                # wrap shift phi = p * f_k * period * m (k-dependent row):
                # sin(theta - phi) = cos(phi) sin(theta) - sin(phi) cos(theta)
                phi = (frequencies * period * mval)
                phi = jnp.concatenate([phi, 2.0 * phi])[None, :]   # (1, 2F)
                cp, sp = jnp.cos(phi), jnp.sin(phi)
                Dmap = jnp.concatenate([
                    cp * ds_a + sp * dc_a,
                    -cp * ds_a - sp * dc_a,
                    -sp * ds_a + cp * dc_a,
                    -sp * ds_a + cp * dc_a,
                ], axis=-1)                                         # (L, 4*2F)
            C = mm(alpha_m, VM).reshape(n, L, T)
            out = out + jnp.sum(C * U[:, None, :] * Dmap[None], axis=-1)
    return out
