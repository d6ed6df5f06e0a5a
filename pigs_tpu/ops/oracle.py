"""Dense O(m*n) Gaussian-mixture field evaluation — the correctness oracle.

Plays the role of the reference's pure-torch twins (gaussians.py:48-116) and extends
them to third order (the CUDA ``sample_gaussians_third_derivative``, reconstructed in
SURVEY.md §2.1).  All math, one fused pass:

  g_i(x)   = exp(-0.5 * d^T C_i d),        d = x - mu_i,  C_i = conic (Sigma^-1)
  u        = sum_i v_i g_i                                           (m, c)
  du/dx_a  = sum_i -P_a g_i v_i,           P = C_i d                 (m, d, c)
  d2u      = sum_i (P_a P_b - C_ab) g_i v_i                          (m, d, d, c)
  d3u      = sum_i (C_ab P_c + C_ac P_b + C_bc P_a - P_a P_b P_c) g_i v_i
                                                                     (m, d, d, d, c)

The "laplacian" output of the reference is in fact the full Hessian
(test_derivatives.py:220-240; SURVEY.md §2.1), and we keep that convention.

Shapes are static; the implementation is plain jnp so JAX autodiff provides exact
gradients of every order w.r.t. means/conics/values/samples (the CUDA extension's
autograd contract, SURVEY.md §2.1 "Autograd contract").  Works in f32 and f64.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["MixtureFields", "eval_mixture_dense"]


class MixtureFields(NamedTuple):
    """Mixture value and spatial derivatives at the query points.

    Fields beyond the requested order are ``None``.
    """

    u: jax.Array                      # (m, c)
    ux: Optional[jax.Array] = None    # (m, d, c)
    uxx: Optional[jax.Array] = None   # (m, d, d, c)  -- full Hessian
    uxxx: Optional[jax.Array] = None  # (m, d, d, d, c)


def wrap_displacement(delta: jax.Array, period) -> jax.Array:
    """Wrap displacements onto the torus ``[-period/2, period/2)`` per axis.

    Implements the periodic-domain behavior of the reference sampler's
    ``GaussianSampler(True)`` torus flag (test_torus.py:15-37; SURVEY.md §2.1
    constructor note) in the kernel itself, instead of shifting means in Python
    (model_pn.py:689-693).
    """
    return delta - period * jnp.round(delta / period)


def eval_mixture_dense(
    means: jax.Array,
    conics: jax.Array,
    values: jax.Array,
    samples: jax.Array,
    order: int = 0,
    mask: Optional[jax.Array] = None,
    period: Optional[float] = None,
) -> MixtureFields:
    """Evaluate the mixture and its derivatives at ``samples``.

    Args:
      means: ``(n, d)`` Gaussian centers.
      conics: ``(n, d, d)`` inverse covariances (symmetric PD).
      values: ``(n, c)`` per-Gaussian coefficients.
      samples: ``(m, d)`` query points.
      order: highest derivative order to compute, 0..3.
      mask: optional ``(n,)`` boolean; inactive Gaussians contribute exactly zero
        (static-shape replacement for the reference's dynamic Gaussian counts).
      period: optional torus period (e.g. ``2 * scale``); displacements wrap.

    Returns:
      :class:`MixtureFields` with entries up to ``order`` filled.
    """
    n, d = means.shape
    m = samples.shape[0]
    # Full float32 (or float64) products: a GPU would otherwise run float32
    # einsums in TF32 (~3 decimal digits), and this is the reference.
    einsum = partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)
    delta = samples[:, None, :] - means[None, :, :]          # (m, n, d)
    if period is not None:
        delta = wrap_displacement(delta, period)
    P = einsum("nab,mnb->mna", conics, delta)            # (m, n, d)
    power = -0.5 * einsum("mna,mna->mn", delta, P)
    g = jnp.exp(power)                                       # (m, n)
    if mask is not None:
        g = g * mask.astype(g.dtype)[None, :]
    gv = g[:, :, None] * values[None, :, :]                  # (m, n, c)

    u = jnp.sum(gv, axis=1)
    ux = uxx = uxxx = None
    if order >= 1:
        ux = -einsum("mna,mnc->mac", P, gv)
    if order >= 2:
        w2 = P[:, :, :, None] * P[:, :, None, :] - conics[None]
        uxx = einsum("mnab,mnc->mabc", w2, gv)
    if order >= 3:
        CP = (conics[None, :, :, :, None] * P[:, :, None, None, :]      # C_ab P_c
              + conics[None, :, :, None, :] * P[:, :, None, :, None]    # C_ac P_b
              + conics[None, :, None, :, :] * P[:, :, :, None, None])   # C_bc P_a
        PPP = P[:, :, :, None, None] * P[:, :, None, :, None] * P[:, :, None, None, :]
        uxxx = einsum("mnabe,mnc->mabec", CP - PPP, gv)
    return MixtureFields(u=u, ux=ux, uxx=uxx, uxxx=uxxx)
