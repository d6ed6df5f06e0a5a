"""Gaussian-mixture parameterization and covariance algebra.

The canonical data model (reference: gaussians.py:163-193, SURVEY.md §2.3):

  * raw means      -> domain means via ``tanh(raw) * scale`` (fitting loops) or raw
  * raw scaling    -> positive per-axis variances via ``exp(raw_scaling)``
  * transforms t   -> bounded off-diagonals ``tanh(t) * sqrt(prod(s))`` keeping the
                      covariance positive-definite
  * conics         -> inverse covariances, computed in closed form (no linalg.inv in
                      the hot path; XLA-friendly, works in any dtype)
  * values v       -> unconstrained per-Gaussian field coefficients, c channels

Everything here is a pure function on jnp arrays; shapes are static.  Supported
dimensions: d in {1, 2, 3}.  The symmetric (d, d) matrices are optionally packed to
``d*(d+1)//2`` floats in row-major upper-triangular order — for d=2 this is
``[s_xx, s_xy, s_yy]``, matching the reference's flat-index ``[0, 1, 3]`` packing
(gaussians.py:186-189).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "tri_size",
    "build_full_covariances",
    "flatten_covariances",
    "build_covariances",
    "unpack_symmetric",
    "pack_symmetric",
    "sym_inverse",
    "sym_eig2x2",
    "principal_axis",
]


def tri_size(d: int) -> int:
    """Number of independent entries of a symmetric (d, d) matrix."""
    return d * (d + 1) // 2


def off_diag_size(d: int) -> int:
    """Number of strictly-lower-triangular entries (the ``transforms`` size)."""
    return d * (d - 1) // 2


def build_full_covariances(scaling: jax.Array, transforms: jax.Array):
    """Build full symmetric covariances and their inverses (conics).

    Args:
      scaling: ``(..., d)`` positive per-axis variances (already exp'd).
      transforms: ``(..., d*(d-1)//2)`` unbounded off-diagonal parameters; mapped
        through ``tanh`` and scaled by ``sqrt(prod(scaling))`` so the matrix stays
        positive definite (reference: gaussians.py:163-176).

    Returns:
      ``(covariances, conics)`` each of shape ``(..., d, d)``.
    """
    d = scaling.shape[-1]
    t = jnp.tanh(transforms) * jnp.sqrt(jnp.prod(scaling, axis=-1, keepdims=True))
    cov = jnp.zeros((*scaling.shape, d), dtype=scaling.dtype)
    # Diagonal.
    diag_idx = jnp.arange(d)
    cov = cov.at[..., diag_idx, diag_idx].set(scaling)
    # Strictly-lower entries in the same (row-major lower-tri) order the reference
    # uses via torch.tril_indices (gaussians.py:173-176), mirrored to upper.
    rows, cols = _tril_indices(d)
    for k, (i, j) in enumerate(zip(rows, cols)):
        cov = cov.at[..., i, j].set(t[..., k])
        cov = cov.at[..., j, i].set(t[..., k])
    conics = sym_inverse(cov)
    return cov, conics


def _tril_indices(d: int):
    rows, cols = [], []
    for i in range(1, d):
        for j in range(i):
            rows.append(i)
            cols.append(j)
    return rows, cols


def _triu_indices(d: int):
    """Row-major upper-triangular (incl. diagonal) index pairs."""
    pairs = []
    for i in range(d):
        for j in range(i, d):
            pairs.append((i, j))
    return pairs


def pack_symmetric(mat: jax.Array) -> jax.Array:
    """Pack a symmetric ``(..., d, d)`` matrix to ``(..., d*(d+1)//2)`` floats.

    Row-major upper-triangular order; for d=2 this yields ``[xx, xy, yy]``, the
    reference's ``[0, 1, 3]`` flat selection (gaussians.py:186-189).
    """
    d = mat.shape[-1]
    comps = [mat[..., i, j] for (i, j) in _triu_indices(d)]
    return jnp.stack(comps, axis=-1)


def unpack_symmetric(packed: jax.Array, d: int) -> jax.Array:
    """Inverse of :func:`pack_symmetric`."""
    out = jnp.zeros((*packed.shape[:-1], d, d), dtype=packed.dtype)
    for k, (i, j) in enumerate(_triu_indices(d)):
        out = out.at[..., i, j].set(packed[..., k])
        if i != j:
            out = out.at[..., j, i].set(packed[..., k])
    return out


def flatten_covariances(covariances: jax.Array, conics: jax.Array):
    """Pack full covariance/conic matrices to triangular storage.

    Mirrors the reference's ``flatten_covariances`` (gaussians.py:186-189) but works
    for any d (the reference hardcodes d=2).
    """
    return pack_symmetric(covariances), pack_symmetric(conics)


def build_covariances(scaling: jax.Array, transforms: jax.Array):
    """``build_full_covariances`` followed by packing (reference gaussians.py:191-193)."""
    cov, con = build_full_covariances(scaling, transforms)
    return flatten_covariances(cov, con)


def sym_inverse(mat: jax.Array) -> jax.Array:
    """Closed-form inverse of symmetric PD ``(..., d, d)`` matrices, d in {1,2,3}.

    Avoids ``jnp.linalg.inv`` so the op lowers to plain elementwise arithmetic
    that XLA fuses, and keeps full dtype flexibility (f32/f64) inside jit and
    Pallas.
    """
    d = mat.shape[-1]
    if d == 1:
        return 1.0 / mat
    if d == 2:
        a = mat[..., 0, 0]
        b = mat[..., 0, 1]
        c = mat[..., 1, 1]
        det = a * c - b * b
        inv_det = 1.0 / det
        row0 = jnp.stack([c * inv_det, -b * inv_det], axis=-1)
        row1 = jnp.stack([-b * inv_det, a * inv_det], axis=-1)
        return jnp.stack([row0, row1], axis=-2)
    if d == 3:
        a, b, c = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
        e, f = mat[..., 1, 1], mat[..., 1, 2]
        i = mat[..., 2, 2]
        A = e * i - f * f
        B = -(b * i - f * c)
        C = b * f - e * c
        E = a * i - c * c
        F = -(a * f - b * c)
        I = a * e - b * b
        det = a * A + b * B + c * C
        inv_det = 1.0 / det
        row0 = jnp.stack([A, B, C], axis=-1)
        row1 = jnp.stack([B, E, F], axis=-1)
        row2 = jnp.stack([C, F, I], axis=-1)
        return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]
    raise ValueError(f"sym_inverse supports d in {{1,2,3}}, got d={d}")


def sym_eig2x2(mat: jax.Array):
    """Closed-form eigendecomposition of symmetric ``(..., 2, 2)`` matrices.

    Returns ``(eigvals, eigvecs)`` with ``eigvals`` ``(..., 2)`` sorted descending by
    magnitude and ``eigvecs`` ``(..., 2, 2)`` whose rows are the unit eigenvectors.
    Replaces the reference's ``torch.linalg.eig`` in the split path
    (model_pn.py:586-590, test_initialize.py:210-216) with an XLA-friendly
    closed form (no complex arithmetic, no host callback).
    """
    a = mat[..., 0, 0]
    b = mat[..., 0, 1]
    c = mat[..., 1, 1]
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = jnp.sqrt(half_diff * half_diff + b * b)
    lam1 = half_tr + disc
    lam2 = half_tr - disc
    # Eigenvector for lam1: pick the numerically larger of the two candidate
    # formulations to avoid 0/0 when b ~ 0.
    v1a = jnp.stack([b, lam1 - a], axis=-1)
    v1b = jnp.stack([lam1 - c, b], axis=-1)
    use_b = jnp.abs(half_diff) + jnp.abs(b) == 0.0  # degenerate (isotropic) case
    pick = (jnp.linalg.norm(v1a, axis=-1, keepdims=True)
            >= jnp.linalg.norm(v1b, axis=-1, keepdims=True))
    v1 = jnp.where(pick, v1a, v1b)
    v1 = jnp.where(use_b[..., None],
                   jnp.stack([jnp.ones_like(a), jnp.zeros_like(a)], axis=-1), v1)
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), 1e-30)
    v2 = jnp.stack([-v1[..., 1], v1[..., 0]], axis=-1)
    eigvals = jnp.stack([lam1, lam2], axis=-1)
    eigvecs = jnp.stack([v1, v2], axis=-2)
    return eigvals, eigvecs


def principal_axis(cov: jax.Array):
    """Largest-|eigenvalue| axis of symmetric covariances, scaled by |eigenvalue|.

    Matches the displacement used by the reference's split
    (``eigvals * eigvec_max``, model_pn.py:586-590): returns ``(..., d)`` equal to
    ``|lambda_max| * v_max``.  d=1 trivially returns the variance itself; d=2 uses the
    closed form.
    """
    d = cov.shape[-1]
    if d == 1:
        return cov[..., 0]
    if d == 2:
        eigvals, eigvecs = sym_eig2x2(cov)
        idx = jnp.argmax(jnp.abs(eigvals), axis=-1)
        lam = jnp.take_along_axis(eigvals, idx[..., None], axis=-1)
        vec = jnp.take_along_axis(eigvecs, idx[..., None, None], axis=-2)[..., 0, :]
        return jnp.abs(lam) * vec
    raise ValueError(f"principal_axis supports d in {{1,2}}, got d={d}")
