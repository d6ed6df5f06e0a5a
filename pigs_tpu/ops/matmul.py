"""Matrix products at the network's stated precision, the same on every backend.

A float32 ``x @ w`` left at the default precision runs in TF32 on NVIDIA GPUs
and in full float32 on the CPU.  The dynamics network instead states its
precision at each product: one bfloat16 pass with float32 accumulation (both
operands rounded to bfloat16, the product's result in float32), forward and
backward, which is the precision the committed checkpoints were trained with
(PERF.md), or exact float32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["matmul"]

_BF16 = jnp.bfloat16
_F32 = jnp.float32


def _mm(a, b):
    return jnp.matmul(a, b, preferred_element_type=_F32)


@jax.custom_vjp
def _bf16_matmul(x, w):
    return _mm(x.astype(_BF16), w.astype(_BF16))


def _bf16_matmul_fwd(x, w):
    xb, wb = x.astype(_BF16), w.astype(_BF16)
    return _mm(xb, wb), (xb, wb)


def _bf16_matmul_bwd(res, g):
    # Both backward products also take bfloat16 operands and return float32,
    # so no gradient is ever rounded to bfloat16 as a result.
    xb, wb = res
    gb = g.astype(_BF16)
    dx = _mm(gb, wb.T)
    dw = _mm(xb.reshape(-1, xb.shape[-1]).T, gb.reshape(-1, gb.shape[-1]))
    return dx, dw


_bf16_matmul.defvjp(_bf16_matmul_fwd, _bf16_matmul_bwd)


def matmul(x: jax.Array, w: jax.Array, bf16: bool) -> jax.Array:
    """``x @ w`` for ``x`` of shape ``(..., k)`` and ``w`` of shape ``(k, n)``.

    ``bf16=True`` and float32 operands: one bfloat16 pass with float32
    accumulation.  Otherwise (``bf16=False``, or float64 operands): exact, at
    ``Precision.HIGHEST``.
    """
    if bf16 and x.dtype == _F32 and w.dtype == _F32:
        return _bf16_matmul(x, w)
    return jnp.matmul(x, w, precision=jax.lax.Precision.HIGHEST)
