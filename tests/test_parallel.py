"""Sharded mixture evaluation equals the single-device oracle (8-dev CPU mesh)."""

import jax
import jax.numpy as jnp
import numpy as np

from pigs_tpu import gaussians
from pigs_tpu.ops.oracle import eval_mixture_dense
from pigs_tpu.parallel.mesh import make_mesh
from pigs_tpu.parallel.sharded import eval_mixture_sharded


def make(key, n=32, d=2, c=2, m=64, dtype=jnp.float64):
    ks = jax.random.split(key, 5)
    means = (jax.random.uniform(ks[0], (n, d), dtype) * 2.0 - 1.0)
    scaling = jnp.exp(jax.random.normal(ks[1], (n, d), dtype) * 0.3 - 2.0)
    transforms = jax.random.normal(ks[2], (n, 1), dtype) * 0.5
    values = jax.random.normal(ks[3], (n, c), dtype)
    _, con = gaussians.build_full_covariances(scaling, transforms)
    samples = (jax.random.uniform(ks[4], (m, d), dtype) * 2.0 - 1.0)
    return means, con, values, samples


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_equals_dense_2d_mesh():
    mesh = make_mesh(shape=(4, 2))
    means, con, values, samples = make(jax.random.PRNGKey(0))
    sharded = eval_mixture_sharded(mesh, means, con, values, samples, order=2)
    dense = eval_mixture_dense(means, con, values, samples, order=2)
    np.testing.assert_allclose(np.asarray(sharded.u), np.asarray(dense.u),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sharded.ux), np.asarray(dense.ux),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sharded.uxx), np.asarray(dense.uxx),
                               rtol=1e-12)


def test_sharded_equals_dense_model_only_mesh():
    mesh = make_mesh(shape=(1, 8))
    means, con, values, samples = make(jax.random.PRNGKey(1), n=40, m=24)
    sharded = eval_mixture_sharded(mesh, means, con, values, samples, order=1,
                                   mask=jnp.arange(40) % 5 != 0)
    dense = eval_mixture_dense(means, con, values, samples, order=1,
                               mask=jnp.arange(40) % 5 != 0)
    np.testing.assert_allclose(np.asarray(sharded.u), np.asarray(dense.u),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(sharded.ux), np.asarray(dense.ux),
                               rtol=1e-12)


def test_sharded_gradients_equal_dense():
    mesh = make_mesh(shape=(2, 4))
    means, con, values, samples = make(jax.random.PRNGKey(2))

    def loss_sharded(means, con, values):
        out = eval_mixture_sharded(mesh, means, con, values, samples, order=1)
        return jnp.sum(out.u ** 2) + jnp.sum(out.ux ** 2)

    def loss_dense(means, con, values):
        out = eval_mixture_dense(means, con, values, samples, order=1)
        return jnp.sum(out.u ** 2) + jnp.sum(out.ux ** 2)

    g1 = jax.grad(loss_sharded, argnums=(0, 1, 2))(means, con, values)
    g2 = jax.grad(loss_dense, argnums=(0, 1, 2))(means, con, values)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_dp_train_step_matches_single_device():
    """shard_map DP training step produces the same update as pn_step's
    single-device math (equal shards -> pmean of local means == global mean)."""
    import optax
    from pigs_tpu.models.model import (ModelConfig, make_initial_state,
                                       sample_fields)
    from pigs_tpu.parallel.train import make_dp_train_step
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.pn import TrainConfig, init_training, pn_step

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=4, ny=4, d=2, scale=1.0, capacity=128,
                             dtype=jnp.float32)
    tcfg = TrainConfig(n_samples=64, seed=0)
    network, params, _, _ = init_training(cfg, tcfg)
    # SGD: parameter updates are linear in the gradients, so the DP and
    # single-device paths must agree to f32 reduction-order noise (Adam's
    # rsqrt normalization amplifies sign flips of near-zero grads).
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3)
    opt_state = opt.init(params)
    state = make_initial_state(cfg)
    key = jax.random.PRNGKey(0)
    m = 64
    samples = (jax.random.uniform(key, (m, 2)) * 2 - 1).astype(jnp.float32)
    ts = jax.random.uniform(key, (m,)).astype(jnp.float32)
    bc = jnp.zeros((m, 2), jnp.float32)
    prev = sample_fields(cfg, state, samples, bc)

    mesh = make_mesh(shape=(8, 1))
    dp_step = make_dp_train_step(mesh, cfg, network, opt)
    p_dp, _, state_dp, _, loss_dp = dp_step(
        params, opt_state, state, prev, samples, ts, bc,
        jnp.asarray(1e-3, jnp.float32), jnp.zeros((), jnp.float32), 1.0)

    p_sd, _, state_sd, _, losses_sd, _, _ = pn_step(
        cfg, network, opt, params, opt_state, state, prev, samples, ts, bc,
        jnp.ones((), jnp.float32), jnp.asarray(1e-3, jnp.float32), 1.0,
        jnp.zeros((), jnp.float32), 1.0)

    np.testing.assert_allclose(float(loss_dp), float(losses_sd.total),
                               rtol=2e-4)
    for a, b in zip(jax.tree_util.tree_leaves(p_dp),
                    jax.tree_util.tree_leaves(p_sd)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=2e-5)


def test_ring_equals_dense():
    from pigs_tpu.parallel.sharded import eval_mixture_ring
    mesh = make_mesh(shape=(2, 4))
    means, con, values, samples = make(jax.random.PRNGKey(5), n=40, m=32)
    mask = jnp.arange(40) % 7 != 0
    ring = eval_mixture_ring(mesh, means, con, values, samples, order=2,
                             mask=mask)
    dense = eval_mixture_dense(means, con, values, samples, order=2, mask=mask)
    for a, b in zip(ring[:3], dense[:3]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-12,
                                   atol=1e-13)


def test_ring_gradients_equal_dense():
    from pigs_tpu.parallel.sharded import eval_mixture_ring
    mesh = make_mesh(shape=(1, 8))
    means, con, values, samples = make(jax.random.PRNGKey(6), n=24, m=16)

    def loss_ring(means, con, values):
        out = eval_mixture_ring(mesh, means, con, values, samples, order=1)
        return jnp.sum(out.u ** 2) + jnp.sum(out.ux ** 2)

    def loss_dense(means, con, values):
        out = eval_mixture_dense(means, con, values, samples, order=1)
        return jnp.sum(out.u ** 2) + jnp.sum(out.ux ** 2)

    g1 = jax.grad(loss_ring, argnums=(0, 1, 2))(means, con, values)
    g2 = jax.grad(loss_dense, argnums=(0, 1, 2))(means, con, values)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)


def test_pallas_under_shard_map_matches_dense():
    """The fused Pallas mixture kernels compile and agree with the dense path
    INSIDE shard_map on a multi-device mesh — values and Gaussian-parameter
    gradients, forward order 2.  CPU runs the kernels through the Pallas
    interpreter; the identical code compiles through Triton on GPUs."""
    mesh = make_mesh(shape=(4, 2))
    means, con, values, samples = make(jax.random.PRNGKey(2), n=32, m=64,
                                       c=1, dtype=jnp.float32)

    def loss(impl):
        def f(means, con, values):
            out = eval_mixture_sharded(mesh, means, con, values, samples,
                                       order=2, impl=impl,
                                       interpret=impl == "pallas")
            return (jnp.sum(out.u ** 2) + jnp.sum(out.ux ** 2)
                    + jnp.sum(out.uxx ** 2))
        return f

    v_p = loss("pallas")(means, con, values)
    g_p = jax.grad(loss("pallas"), argnums=(0, 1, 2))(means, con, values)
    v_d = loss("xla")(means, con, values)
    g_d = jax.grad(loss("xla"), argnums=(0, 1, 2))(means, con, values)
    np.testing.assert_allclose(float(v_p), float(v_d), rtol=1e-5)
    for k, (a, b) in enumerate(zip(g_p, g_d)):
        a, b = np.asarray(a), np.asarray(b)
        if k == 1:  # pallas conic grad is symmetrized
            a = 0.5 * (a + np.swapaxes(a, -1, -2))
            b = 0.5 * (b + np.swapaxes(b, -1, -2))
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-4)


def test_ring_pallas_matches_dense():
    """Ring-accumulation (ppermute) path with the fused kernel per shard."""
    from pigs_tpu.parallel.sharded import eval_mixture_ring

    mesh = make_mesh(shape=(2, 4))
    means, con, values, samples = make(jax.random.PRNGKey(3), n=32, m=64,
                                       c=1, dtype=jnp.float32)
    ring = eval_mixture_ring(mesh, means, con, values, samples, order=1,
                             impl="pallas", interpret=True)
    dense = eval_mixture_dense(means, con, values, samples, order=1)
    np.testing.assert_allclose(np.asarray(ring.u), np.asarray(dense.u),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ring.ux), np.asarray(dense.ux),
                               rtol=1e-4, atol=1e-5)
