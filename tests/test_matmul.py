"""The network's stated product precision (pigs_tpu/ops/matmul.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pigs_tpu.ops.matmul import matmul


def _round_bf16(x):
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32),
                      np.float64)


@pytest.mark.parametrize("x_shape", [(7,), (5, 7), (3, 5, 7)])
def test_bf16_products_forward_and_backward(x_shape):
    """Forward and both backward products take bfloat16-rounded operands and
    accumulate in float32; nothing else is rounded."""
    kx, kw, kg = jax.random.split(jax.random.PRNGKey(0), 3)
    x = jax.random.normal(kx, x_shape, jnp.float32)
    w = jax.random.normal(kw, (7, 4), jnp.float32)
    y, vjp = jax.vjp(lambda a, b: matmul(a, b, True), x, w)
    g = jax.random.normal(kg, y.shape, jnp.float32)
    dx, dw = vjp(g)
    assert y.dtype == dx.dtype == dw.dtype == jnp.float32
    xr, wr, gr = _round_bf16(x), _round_bf16(w), _round_bf16(g)
    np.testing.assert_allclose(np.asarray(y), xr @ wr, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.asarray(dx), gr @ wr.T, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(dw), xr.reshape(-1, 7).T @ gr.reshape(-1, 4), rtol=1e-6,
        atol=1e-6)
    # The rounding is real: the exact product differs.
    exact = np.asarray(x, np.float64) @ np.asarray(w, np.float64)
    assert np.abs(np.asarray(y) - exact).max() > 1e-4


@pytest.mark.parametrize("bf16,dtype", [(False, jnp.float32),
                                        (True, jnp.float64),
                                        (False, jnp.float64)])
def test_exact_products(bf16, dtype):
    """``bf16=False``, and float64 operands either way, give exact products."""
    with jax.enable_x64(dtype == jnp.float64):
        kx, kw = jax.random.split(jax.random.PRNGKey(1))
        x = jax.random.normal(kx, (6, 5), dtype)
        w = jax.random.normal(kw, (5, 3), dtype)
        y = matmul(x, w, bf16)
        assert y.dtype == dtype
        np.testing.assert_allclose(
            np.asarray(y), np.asarray(x, np.float64) @ np.asarray(w, np.float64),
            rtol=1e-6 if dtype == jnp.float32 else 1e-12)


def test_network_products_follow_the_flag():
    """``DynamicsNetwork.bf16_products`` reaches every product: the two
    settings agree to bfloat16 resolution but not bit for bit, and the
    default is bfloat16."""
    import dataclasses
    from pigs_tpu.models.model import (ModelConfig, forward_step,
                                       make_initial_state, make_network)
    from pigs_tpu.pde import IntegrationRule, Problem
    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, capacity=256)
    network = make_network(cfg)
    assert network.bf16_products
    params = network.init(jax.random.PRNGKey(0))
    state = make_initial_state(cfg)
    _, d_bf16 = forward_step(cfg, network, params, state)
    _, d_f32 = forward_step(
        cfg, dataclasses.replace(network, bf16_products=False), params, state)
    for a, b in zip(d_bf16, d_f32):
        a, b = np.asarray(a), np.asarray(b)
        scale = np.abs(b).max()
        assert np.abs(a - b).max() <= 5e-2 * scale
    assert any(not np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(d_bf16, d_f32))
