"""No-MLP direct solver: IC fitting converges, PDE timestep optimizes, densify.

The behavioral analog of the reference's CPU-runnable 1D config
(test_no_mlp_1d.py).
"""

import jax
import jax.numpy as jnp
import numpy as np

from pigs_tpu.ops.mixture import eval_mixture
from pigs_tpu.pde import Problem
from pigs_tpu.train.no_mlp import (NoMLPConfig, concrete, densify,
                                   draw_samples, init_params, solve_timestep)
import optax


def cfg_1d(**kw):
    defaults = dict(problem=Problem.BURGERS, d=1, scale=2.5, n_init=25,
                    capacity=64, n_samples=128, dt=0.05, block_iters=50,
                    max_iters=600, tol=1e-4, dtype=jnp.float32)
    defaults.update(kw)
    return NoMLPConfig(**defaults)


def test_fit_initial_condition_1d():
    cfg = cfg_1d()
    params, active = init_params(cfg)
    params, active, loss = solve_timestep(cfg, params, active, None,
                                          jax.random.PRNGKey(0),
                                          first_step=True)
    assert loss < 5e-3, loss
    # Rendered field matches the target bump.
    means, conics, values = concrete(cfg, params)
    xs = jnp.linspace(-1, 1, 100, dtype=jnp.float32).reshape(-1, 1) * cfg.scale
    out = eval_mixture(means, conics, values, xs, order=0, mask=active)
    desired = np.exp(-2.0 * np.asarray(xs[:, 0]) ** 2)
    err = np.mean((np.asarray(out.u[:, 0]) - desired) ** 2)
    assert err < 1e-2, err


def test_pde_timestep_reduces_residual_1d():
    cfg = cfg_1d(max_iters=800)
    params, active = init_params(cfg)
    params, active, _ = solve_timestep(cfg, params, active, None,
                                       jax.random.PRNGKey(0), first_step=True)
    means, conics, values = concrete(cfg, params)
    prev = (means, conics, values, active)
    # Loss after a single block (baseline) vs after the full optimization.
    cfg_short = cfg._replace(max_iters=cfg.block_iters)
    _, _, loss_short = solve_timestep(cfg_short, params, active, prev,
                                      jax.random.PRNGKey(1), first_step=False)
    params2, active2, loss = solve_timestep(cfg, params, active, prev,
                                            jax.random.PRNGKey(1),
                                            first_step=False)
    assert np.isfinite(loss)
    assert loss < 0.05, loss
    assert loss <= loss_short + 1e-6, (loss, loss_short)


def test_densify_prunes_and_splits():
    cfg = cfg_1d(capacity=40)
    params, active = init_params(cfg)
    # Make some values large (kept), some tiny (pruned).
    values = params.values.at[:, 0].set(0.5)
    values = values.at[5, 0].set(0.001)   # pruned: |v| < 0.01
    params = params._replace(values=values)
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(params)
    # Fake accumulated gradients: one slot dominates -> split.
    grad = jnp.zeros_like(params.raw_means).at[7, 0].set(10.0)
    new_params, new_opt_state, new_active = densify(cfg, params, opt_state,
                                                    active, grad)
    a0 = np.asarray(active)
    a1 = np.asarray(new_active)
    assert a1[7]                 # split parent kept
    assert a1.sum() == a0.sum()  # one pruned + one child added
    # The child landed in some free slot (pruned slots are reusable), displaced
    # by the accumulated gradient.
    expected_child = float(params.raw_means[7, 0] + 10.0)
    child_slots = np.nonzero(
        np.isclose(np.asarray(new_params.raw_means[:, 0]), expected_child)
        & a1)[0]
    assert len(child_slots) == 1
    child = int(child_slots[0])
    assert child != 7
    # Adam moments of the child slot are zero.
    adam_state = new_opt_state[0]
    assert float(jnp.sum(jnp.abs(adam_state.mu.raw_means[child]))) == 0.0


def test_densify_min_keep_guards_collapse():
    """min_keep stops the reference keep-criterion from pruning the whole
    mixture: when every value is below the 0.01 threshold, the top min_keep
    slots by value norm survive."""
    cfg = cfg_1d(capacity=40, min_keep=8)
    params, active = init_params(cfg)
    # All values below the prune threshold -> reference semantics would
    # deactivate everything.
    values = jnp.linspace(1e-4, 5e-3, cfg.capacity).reshape(-1, 1)
    params = params._replace(values=values.astype(params.values.dtype))
    opt = optax.adam(cfg.lr)
    opt_state = opt.init(params)
    grad = jnp.zeros_like(params.raw_means)
    _, _, new_active = densify(cfg, params, opt_state, active, grad)
    kept = np.nonzero(np.asarray(new_active))[0]
    assert len(kept) == 8
    # The survivors are the largest-value active slots.
    vnorm = np.array(jnp.abs(values[:, 0]), copy=True)
    vnorm[~np.asarray(active)] = -np.inf
    expected = set(np.argsort(vnorm)[-8:])
    assert set(kept) == expected
    # With min_keep=0 (reference semantics) the same state collapses.
    cfg0 = cfg_1d(capacity=40, min_keep=0)
    _, _, act0 = densify(cfg0, params, opt_state, active, grad)
    assert np.asarray(act0).sum() == 0


def test_fit_initial_condition_2d_wave():
    """2D wave IC fit (test_no_mlp.py config): channel 1 fits the bump,
    channel 0 stays near zero."""
    cfg = NoMLPConfig(problem=Problem.WAVE, d=2, scale=2.5, n_init=10,
                      capacity=128, n_samples=256, dt=0.1, block_iters=50,
                      max_iters=500, tol=1e-3, dtype=jnp.float32)
    params0, active0 = init_params(cfg)
    params, active, loss = solve_timestep(cfg, params0, active0, None,
                                          jax.random.PRNGKey(0),
                                          first_step=True)
    assert loss < 0.05, loss
    means, conics, values = concrete(cfg, params)
    center = jnp.zeros((1, 2), jnp.float32)
    out = eval_mixture(means, conics, values, center, order=0, mask=active)
    assert float(out.u[0, 1]) > 0.5        # bump in channel 1
    assert abs(float(out.u[0, 0])) < 0.3   # channel 0 suppressed


def test_draw_samples_active_concentration():
    """Importance sampling draws land near the active Gaussians and inside
    the domain; active_sampling=0 reproduces plain uniform sampling."""
    cfg = NoMLPConfig(problem=Problem.WAVE, d=2, scale=2.5, n_init=5,
                      capacity=64, n_samples=256, active_sampling=0.5)
    params, active = init_params(cfg)
    key = jax.random.PRNGKey(0)

    pts = draw_samples(cfg, key, params, active)
    assert pts.shape == (256, 2)
    assert jnp.all(jnp.abs(pts) <= cfg.scale)
    # Active Gaussians sit within |x| <= 0.25 (tanh(arctanh(0.1*grid))*2.5);
    # with sigma = exp(-4/2)*3 ~ 0.4 the first half must concentrate there.
    act_half = pts[:128]
    frac_near = jnp.mean(jnp.all(jnp.abs(act_half) < 1.5, axis=-1))
    assert float(frac_near) > 0.95
    # The uniform half covers the domain (mean |x| of U[-2.5,2.5] is 1.25).
    uni_half = pts[128:]
    assert float(jnp.mean(jnp.abs(uni_half))) > 0.9

    cfg0 = cfg._replace(active_sampling=0.0)
    uni = draw_samples(cfg0, key, params, active)
    assert uni.shape == (256, 2)
    assert float(jnp.mean(jnp.abs(uni))) > 0.9
    # Inactive slots are never proposed from: mask out all but slot 0.
    one = active & (jnp.arange(cfg.capacity) == 0)
    pts1 = draw_samples(cfg, key, params, one)
    mean0 = jnp.tanh(params.raw_means[0]) * cfg.scale
    # Mean distance of the proposals from slot 0's mean is ~sigma*E|z| ~ 0.5;
    # uniform draws over the 5x5 domain would average ~2.
    assert float(jnp.mean(jnp.linalg.norm(pts1[:128] - mean0, axis=-1))) < 1.0
