"""Public mixture-evaluation API: blockwise, jit-able, autodiff-complete.

This is the functional replacement for the reference's stateful
``GaussianSampler.preprocess`` + ``sample_gaussians*`` protocol (SURVEY.md §2.1):
one call evaluates value and all requested derivative orders in a single fused pass
(the reference recomputes the exponent once per method; here the density is computed
once per (sample, Gaussian) pair).

Scaling strategy: the all-pairs reduction is shaped exactly like attention
(samples ~ queries, Gaussians ~ keys; SURVEY.md §5 long-context note).  The default
blockwise path chunks the sample axis with ``lax.map`` so peak memory is
O(chunk * n * d^order) while XLA fuses the inner dense evaluation; the fused Pallas
kernels (``pigs_tpu.ops.pallas_mixture``, Triton route) keep the per-pair
intermediates in registers instead, and :func:`use_fused_kernel` decides where
they run.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

from pigs_tpu.ops.oracle import MixtureFields, eval_mixture_dense

__all__ = ["eval_mixture", "eval_mixture_region", "eval_mixture_image",
           "use_fused_kernel"]


def _pad_to_multiple(x: jax.Array, multiple: int, axis: int = 0):
    size = x.shape[axis]
    padded = (size + multiple - 1) // multiple * multiple
    if padded == size:
        return x, size
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, padded - size)
    return jnp.pad(x, pad_widths), size


def use_fused_kernel(platform: str, d: int, dtype) -> bool:
    """The rule behind ``impl="auto"``: the fused kernels on an NVIDIA GPU for
    d in (1, 2) in float32, the blockwise XLA path everywhere else."""
    return platform == "gpu" and d in (1, 2) and dtype == jnp.float32


def _eval_d1_via_d2(means, conics, values, samples, order, mask, period,
                    diff_samples, interpret):
    """d=1 on the fused d=2 kernel: embed on the x-axis with a zero second
    coordinate and a conic whose dummy row/column is zero, so the exponent,
    every derivative order, and every adjoint are exactly the 1D values in the
    leading index (NOTES.md r1 item 5; closes the d=1 gap without a second
    kernel).  The pad/slice wrappers are plain XLA, so autodiff (including
    grad-of-grad through the dense fallback) composes."""
    from pigs_tpu.ops.pallas_mixture import eval_mixture_pallas
    n, m = means.shape[0], samples.shape[0]
    dt = values.dtype
    zeros_n = jnp.zeros((n, 1), dt)
    means2 = jnp.concatenate([means.reshape(n, 1), zeros_n], axis=-1)
    c11 = conics.reshape(n, 1, 1)
    row2 = jnp.zeros((n, 1, 2), dt)
    conics2 = jnp.concatenate(
        [jnp.concatenate([c11, jnp.zeros((n, 1, 1), dt)], axis=-1), row2],
        axis=-2)
    samples2 = jnp.concatenate(
        [samples.reshape(m, 1), jnp.zeros((m, 1), dt)], axis=-1)
    out = eval_mixture_pallas(means2, conics2, values, samples2, order=order,
                              mask=mask, period=period,
                              diff_samples=diff_samples, interpret=interpret)
    return MixtureFields(
        u=out.u,
        ux=None if out.ux is None else out.ux[:, :1],
        uxx=None if out.uxx is None else out.uxx[:, :1, :1],
        uxxx=None if out.uxxx is None else out.uxxx[:, :1, :1, :1],
    )


@partial(jax.jit, static_argnames=("order", "period", "sample_chunk", "impl",
                                   "diff_samples", "interpret"))
def eval_mixture(
    means: jax.Array,
    conics: jax.Array,
    values: jax.Array,
    samples: jax.Array,
    order: int = 0,
    mask: Optional[jax.Array] = None,
    period: Optional[float] = None,
    sample_chunk: int = 1024,
    impl: str = "auto",
    diff_samples: bool = True,
    interpret: bool = False,
) -> MixtureFields:
    """Evaluate a Gaussian mixture field (value + derivatives) at sample points.

    Same contract as :func:`pigs_tpu.ops.oracle.eval_mixture_dense`; chunks the
    sample axis to bound memory.  Differentiable w.r.t. every tensor input to any
    order (JAX autodiff through the blocked map).

    ``diff_samples=False`` promises the caller never differentiates w.r.t.
    ``samples`` (true of every training loop — collocation points are
    constants); the fused path then skips its sample-grad kernel, halving the
    backward.  The blockwise path ignores the flag (autodiff handles it).

    ``impl``: "auto" follows :func:`use_fused_kernel`; "xla" forces the
    blockwise path; "pallas" forces the fused kernels.  ``interpret=True`` runs
    the fused kernels through the Pallas interpreter (CPU tests only).

    Note ``conics`` here is the full symmetric ``(n, d, d)`` inverse covariance.
    Packed triangular storage from :func:`pigs_tpu.gaussians.build_covariances` can
    be expanded with :func:`pigs_tpu.gaussians.unpack_symmetric`.
    """
    d = samples.shape[-1]
    if impl == "auto":
        use_pallas = use_fused_kernel(jax.default_backend(), d, samples.dtype)
    else:
        use_pallas = impl == "pallas"
    if use_pallas:
        from pigs_tpu.ops.pallas_mixture import eval_mixture_pallas
        if d == 1:
            return _eval_d1_via_d2(means, conics, values, samples, order=order,
                                   mask=mask, period=period,
                                   diff_samples=diff_samples,
                                   interpret=interpret)
        return eval_mixture_pallas(means, conics, values, samples, order=order,
                                   mask=mask, period=period,
                                   diff_samples=diff_samples,
                                   interpret=interpret)

    m = samples.shape[0]
    if m <= sample_chunk:
        return eval_mixture_dense(
            means, conics, values, samples, order=order, mask=mask, period=period)

    padded_samples, true_m = _pad_to_multiple(samples, sample_chunk, axis=0)
    blocks = padded_samples.reshape(-1, sample_chunk, samples.shape[-1])

    def block_fn(block):
        return eval_mixture_dense(
            means, conics, values, block, order=order, mask=mask, period=period)

    out = jax.lax.map(block_fn, blocks)
    merged = []
    for field in out:
        if field is None:
            merged.append(None)
        else:
            flat = field.reshape(-1, *field.shape[2:])
            merged.append(flat[:true_m])
    return MixtureFields(*merged)


def eval_mixture_region(means, conics, values, center, size: int, dx: float,
                        order: int = 0, mask=None, period=None) -> MixtureFields:
    """Evaluate on a ``size^d`` grid of offsets around ``center``.

    Working version of the reference's broken ``sample_gaussians_region``
    (gaussians.py:68-71 calls an undefined helper; SURVEY.md §2.2 defect list).
    """
    from pigs_tpu.utils.sampling import region_kernel
    d = means.shape[-1]
    offsets = region_kernel(size, dx, d, dtype=means.dtype)
    return eval_mixture(means, conics, values,
                        jnp.asarray(center).reshape(1, d) + offsets,
                        order=order, mask=mask, period=period)


def eval_mixture_image(means, conics, values, res: int, scale: float = 1.0,
                       mask=None, period=None) -> jax.Array:
    """Render the field on the reference's image grid (gaussians.py:73-87):
    returns ``(res, res, c)`` with xy indexing and the y axis flipped."""
    from pigs_tpu.utils.sampling import image_samples
    samples = image_samples(res, scale, dtype=means.dtype)
    out = eval_mixture(means, conics, values, samples, order=0, mask=mask,
                       period=period)
    return out.u.reshape(res, res, -1)
