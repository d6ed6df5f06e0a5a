"""The fused mixture kernels as compiled for the GPU, against the float64 dense
oracle.  Marked ``gpu``: these skip without an NVIDIA GPU (see conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pigs_tpu import gaussians
from pigs_tpu.ops.mixture import eval_mixture, use_fused_kernel
from pigs_tpu.ops.oracle import eval_mixture_dense

pytestmark = pytest.mark.gpu


def make(n, m, c, d=2, seed=0):
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    f32 = jnp.float32
    means = jax.random.uniform(ks[0], (n, d), f32) * 2.0 - 1.0
    scaling = jnp.exp(jax.random.normal(ks[1], (n, d), f32) * 0.3 - 2.5)
    if d == 2:
        _, conics = gaussians.build_full_covariances(
            scaling, jax.random.normal(ks[2], (n, 1), f32) * 0.5)
    else:
        conics = (1.0 / scaling ** 2)[:, :, None]
    values = jax.random.normal(ks[3], (n, c), f32)
    samples = jax.random.uniform(ks[4], (m, d), f32) * 2.0 - 1.0
    cots = [jax.random.normal(jax.random.fold_in(ks[5], k),
                              (m,) + (d,) * k + (c,), f32) for k in range(4)]
    return (means, conics, values, samples), cots


def linear_loss(fn, order, period, cots, mask):
    def loss(means, conics, values, samples):
        out = fn(means, conics, values, samples, order=order, mask=mask,
                 period=period)
        return sum(jnp.sum(f * w) for f, w in zip(out[:order + 1], cots))
    return loss


def assert_close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= rel, (err, rel)


def sym(g):
    return 0.5 * (g + np.swapaxes(g, -1, -2))


@pytest.mark.parametrize("order,c,period,d", [
    (0, 1, None, 2), (1, 2, None, 2), (2, 1, None, 2), (3, 2, 2.0, 2),
    (2, 1, None, 1)])
def test_compiled_kernel_matches_f64_oracle(gpu, order, c, period, d):
    """Values and all four gradients (samples included, so the sample-grad
    kernel runs) at ragged sizes."""
    assert use_fused_kernel(gpu.platform, d, jnp.float32)
    args, cots = make(n=333, m=1001, c=c, d=d)
    mask = jnp.arange(333) % 7 != 0
    fused = jax.jit(lambda *a: eval_mixture(*a, order=order, mask=mask,
                                            period=period))(*args)
    grads = jax.jit(jax.grad(linear_loss(eval_mixture, order, period, cots,
                                         mask), argnums=(0, 1, 2, 3)))(*args)
    with jax.enable_x64(True):
        args64 = [jnp.asarray(np.asarray(x), jnp.float64) for x in args]
        cots64 = [jnp.asarray(np.asarray(w), jnp.float64) for w in cots]
        ref = eval_mixture_dense(*args64, order=order, mask=mask,
                                 period=period)
        ref_grads = jax.grad(linear_loss(eval_mixture_dense, order, period,
                                         cots64, mask),
                             argnums=(0, 1, 2, 3))(*args64)
    for k in range(order + 1):
        assert_close(fused[k], ref[k], 1e-5 if k == 0 else 1e-4)
    for k, (a, b) in enumerate(zip(grads, ref_grads)):
        if k == 1:
            a, b = sym(np.asarray(a)), sym(np.asarray(b))
        assert_close(a, b, 1e-4)


def test_grad_of_grad_on_gpu(gpu):
    """Second-order differentiation: the fused first-order backward, then the
    dense oracle's vjp for the outer derivative."""
    args, _ = make(n=40, m=64, c=1, seed=3)
    means, conics, values, samples = args

    def outer(fn):
        def inner(mu, co, v):
            out = fn(mu, co, v, samples, order=2)
            return jnp.sum(out.u ** 2) + jnp.sum(out.uxx ** 2)

        def f(mu, co, v):
            gm, gc, gv = jax.grad(inner, argnums=(0, 1, 2))(mu, co, v)
            gc = 0.5 * (gc + jnp.swapaxes(gc, -1, -2))
            return jnp.sum(gm ** 2) + jnp.sum(gc ** 2) + jnp.sum(gv ** 2)
        return f

    got = jax.grad(outer(eval_mixture), argnums=(0, 1, 2))(means, conics,
                                                          values)
    ref = jax.grad(outer(eval_mixture_dense), argnums=(0, 1, 2))(
        means, conics, values)
    for k, (a, b) in enumerate(zip(got, ref)):
        if k == 1:
            a, b = sym(np.asarray(a)), sym(np.asarray(b))
        assert_close(a, b, 1e-3)
