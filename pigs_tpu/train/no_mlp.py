"""Direct ("no-MLP") PDE solving by optimizing Gaussian parameters per timestep.

Functional redesign of the reference's test_no_mlp.py / test_no_mlp_1d.py drivers
(call stack: SURVEY.md §3.3): per timestep, Adam-optimize raw Gaussian parameters
against the PDE residual between the frozen previous mixture and the current one;
periodically prune weak Gaussians and split high-gradient ones.

Static-shape structure: parameters live in fixed-capacity padded buffers with an
active mask; the inner optimization is a jitted ``lax.scan`` over iterations; the
outer convergence check and densification happen at block boundaries in Python
(one recompile-free jit per block).  Adam-moment "surgery" (test_no_mlp.py:218-245)
reduces to zeroing the moment rows of re-initialized slots.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from pigs_tpu import gaussians
from pigs_tpu.models.state import compact_scatter
from pigs_tpu.ops.mixture import eval_mixture
from pigs_tpu.pde import Problem

__all__ = ["NoMLPConfig", "RawParams", "init_params", "concrete",
           "solve", "solve_timestep", "densify", "draw_samples"]


class RawParams(NamedTuple):
    """Optimizable raw parameters (padded to capacity).

    ``raw_means`` map to domain means via ``tanh(raw) * scale``
    (test_no_mlp.py:99); ``raw_scaling`` via ``exp`` (test_no_mlp.py:100);
    ``transforms`` are raw off-diagonals (empty for d=1).
    """

    raw_means: jax.Array    # (N, d)
    values: jax.Array       # (N, c)
    raw_scaling: jax.Array  # (N, d)
    transforms: jax.Array   # (N, T)


class NoMLPConfig(NamedTuple):
    problem: Problem
    d: int
    scale: float = 2.5
    n_init: int = 25          # initial grid edge (d=1: count; d=2: nx=ny)
    capacity: int = 1024
    n_samples: int = 128
    dt: float = 0.05
    nu: float = 1.0 / (100.0 * np.pi)
    lr: float = 1e-2
    block_iters: int = 100    # iterations per jitted block (the reference's
                              # log_step cadence, test_no_mlp_1d.py:32)
    max_iters: int = 5000
    tol: float = 1e-4
    init_raw_scaling: float = -4.0
    dtype: jnp.dtype = jnp.float32
    warm_up_blocks: int = 0
    """Blocks (of ``block_iters`` each) to run before densification may fire
    within a timestep.  The reference gates densification on
    ``(j+1)//densification_step > warm_up`` with warm_up=100 periods of 301
    iterations (test_no_mlp.py:30-32,188) — i.e. >30,100 iterations, which its
    5,000-iteration cap never reaches, so the reference's 2D runs never
    actually prune or split.  Round-2's committed 2D runs densified every 3
    blocks from iteration 0 and annihilated the mixture (VERDICT r2 item 1);
    this knob restores the reference's effective behavior while keeping
    densification available for longer solves."""
    min_keep: int = 0
    """If > 0, pruning never leaves fewer than this many active Gaussians:
    when the reference keep-criterion (||v|| > 0.01 and sum(var) < 0.5,
    test_no_mlp.py:198-200) would underflow it, the top ``min_keep`` active
    slots by value norm are kept instead.  Guards long 2D solves against
    total mixture collapse once the solution steepens (the reference's
    criterion can prune ALL Gaussians after a diverged step).  0 = reference
    semantics."""
    active_sampling: float = 0.0
    """Fraction of collocation samples drawn around the *active Gaussians*
    (x = mean + inflate * sqrt(var) * z, clipped to the domain) instead of
    uniformly over [-scale, scale]^d.  The reference samples uniformly
    (test_no_mlp.py:85-88), which starves localized solutions: a WAVE bump
    of variance 0.01*scale covers ~1%% of the 2D domain, so a 512-point
    uniform draw lands ~6 points on it and the residual there is never
    resolved.  Importance sampling reweights the residual MSE toward where
    the field actually lives.  0 = reference semantics (uniform)."""
    sampling_inflate: float = 3.0
    """Std-dev inflation for ``active_sampling`` draws: covers the Gaussian's
    support and its immediate neighborhood (where it must move next)."""
    lr_min: Optional[float] = None
    """If set, cosine-decay the Adam learning rate from ``lr`` to ``lr_min``
    over each timestep's ``max_iters`` iterations.  At fixed lr the
    stochastic residual loss plateaus at Adam's noise floor — parameter
    jitter ~lr feeds ``ut = du/dt`` amplified by 1/dt, so small-dt solves
    can never reach ``tol``.  The reference experimented with exactly this
    (commented-out lr adaptation, test_no_mlp.py:178-183); None = reference
    semantics (constant lr)."""

    @property
    def c(self) -> int:
        return 2 if self.problem == Problem.WAVE else 1


def init_params(cfg: NoMLPConfig) -> Tuple[RawParams, jax.Array]:
    """Initial grid of Gaussians, padded to capacity, with the active mask."""
    d, dt = cfg.d, cfg.dtype
    if d == 1:
        n = cfg.n_init
        means = jnp.linspace(-1, 1, n, dtype=dt).reshape(-1, 1)
    else:
        n = cfg.n_init * cfg.n_init
        t = jnp.linspace(-1, 1, cfg.n_init, dtype=dt) * 0.1
        gx, gy = jnp.meshgrid(t, t, indexing="ij")
        means = jnp.arctanh(jnp.stack([gx, gy], axis=-1).reshape(-1, d))
    T = d * (d - 1) // 2
    pad = cfg.capacity - n
    params = RawParams(
        raw_means=jnp.pad(means, ((0, pad), (0, 0))),
        values=jnp.zeros((cfg.capacity, cfg.c), dt),
        raw_scaling=jnp.full((cfg.capacity, d), cfg.init_raw_scaling, dt),
        transforms=jnp.zeros((cfg.capacity, T), dt),
    )
    active = jnp.arange(cfg.capacity) < n
    return params, active


def concrete(cfg: NoMLPConfig, params: RawParams):
    """Raw parameters -> (means, conics, values) full matrices."""
    means = jnp.tanh(params.raw_means) * cfg.scale
    scaling = jnp.exp(params.raw_scaling)
    if cfg.d == 1:
        conics = (1.0 / scaling)[..., None]  # (N, 1, 1)
    else:
        _, conics = gaussians.build_full_covariances(scaling, params.transforms)
    return means, conics, params.values


def draw_samples(cfg: NoMLPConfig, key: jax.Array, params: RawParams,
                 active: jax.Array, first_step: bool = False) -> jax.Array:
    """Collocation points: uniform over the domain, optionally mixed with
    draws around the active Gaussians (see ``NoMLPConfig.active_sampling``).

    For the WAVE IC fit the reference concentrates samples near the bump —
    ``(randn/2).clamp(-1,1) * scale`` (test_no_mlp.py:85-86) — because the
    d=2 wave IC has variance ``0.01*scale`` and uniform draws would land ~3
    of 1024 points on it; that path is reproduced here.

    Axis-aligned proposal (rotation is ignored; ``sampling_inflate`` covers
    the slack) — this is a *sampler*, not a density; the residual loss simply
    becomes a reweighted MSE.  Static shapes: the split point is a Python int.
    """
    k_u, k_idx, k_z = jax.random.split(key, 3)
    if first_step and cfg.problem == Problem.WAVE and cfg.d == 2:
        return jnp.clip(
            jax.random.normal(k_u, (cfg.n_samples, cfg.d), cfg.dtype) / 2.0,
            -1.0, 1.0) * cfg.scale
    samples = ((jax.random.uniform(k_u, (cfg.n_samples, cfg.d), cfg.dtype)
                * 2.0 - 1.0) * cfg.scale)
    n_act = int(round(cfg.n_samples * cfg.active_sampling))
    if n_act == 0:
        return samples
    means = jax.lax.stop_gradient(jnp.tanh(params.raw_means) * cfg.scale)
    sigma = jax.lax.stop_gradient(
        jnp.sqrt(jnp.exp(params.raw_scaling)) * cfg.sampling_inflate)
    logits = jnp.where(active, 0.0, -jnp.inf)
    idx = jax.random.categorical(k_idx, logits, shape=(n_act,))
    z = jax.random.normal(k_z, (n_act, cfg.d), cfg.dtype)
    pts = jnp.clip(means[idx] + sigma[idx] * z, -cfg.scale, cfg.scale)
    return jnp.concatenate([pts, samples[n_act:]], axis=0)


def _initial_target(cfg: NoMLPConfig, samples: jax.Array) -> jax.Array:
    """IC targets (test_no_mlp.py:107-120, test_no_mlp_1d.py:116-129)."""
    if cfg.d == 1:
        return jnp.exp(-2.0 * samples[:, 0] ** 2)
    var = (0.01 if cfg.problem == Problem.WAVE else 0.1) * cfg.scale
    power = -0.5 * jnp.sum(samples * samples, axis=-1) / var
    return jnp.exp(power)


def _pde_residual_loss(cfg: NoMLPConfig, u, ux, uxx, ut):
    """Per-problem residual (test_no_mlp.py:135-144, test_no_mlp_1d.py:144-151)."""
    p = cfg.problem
    if cfg.d == 1:
        lap = uxx[:, 0, 0, 0]
    else:
        lap = uxx[:, 0, 0, 0] + uxx[:, 1, 1, 0]
    if p == Problem.WAVE:
        loss1 = jnp.mean((ut[:, 1] - (10.0 * lap - 0.1 * u[:, 1])) ** 2)
        loss2 = jnp.mean((ut[:, 0] - u[:, 1]) ** 2)
        w1 = 0.1 if cfg.d == 1 else 0.01
        return w1 * loss1 + loss2
    if p == Problem.BURGERS:
        return jnp.mean((ut[:, 0] - (cfg.nu * lap - u[:, 0] * ux[:, 0, 0])) ** 2)
    if p == Problem.DIFFUSION:
        return jnp.mean((ut[:, 0] - lap) ** 2)
    raise ValueError(f"no-MLP solver does not support {p}")


def _loss_fn(cfg: NoMLPConfig, params: RawParams, active, prev, samples,
             time_samples, first_step: bool):
    means, conics, values = concrete(cfg, params)
    if first_step:
        out = eval_mixture(means, conics, values, samples, order=0, mask=active,
                           diff_samples=False)
        desired = _initial_target(cfg, samples)
        if cfg.problem == Problem.WAVE:
            if cfg.d == 1:
                return (jnp.mean((out.u[:, 0] - desired) ** 2)
                        + jnp.mean((out.u[:, 1] - desired) ** 2))
            return (jnp.mean((out.u[:, 1] - desired) ** 2)
                    + jnp.mean(out.u[:, 0] ** 2))
        return jnp.mean((out.u[:, 0] - desired) ** 2)

    prev_u, prev_ux, prev_uxx = prev
    out = eval_mixture(means, conics, values, samples, order=2, mask=active,
                       diff_samples=False)
    ut = (out.u - prev_u) / cfg.dt
    ts = time_samples
    u = ts[:, None] * prev_u + (1 - ts[:, None]) * out.u
    ux = ts[:, None, None] * prev_ux + (1 - ts[:, None, None]) * out.ux
    uxx = (ts[:, None, None, None] * prev_uxx
           + (1 - ts[:, None, None, None]) * out.uxx)
    return _pde_residual_loss(cfg, u, ux, uxx, ut)


def _make_opt(cfg: NoMLPConfig):
    """Adam, optionally with an in-step cosine lr schedule (lr -> lr_min over
    max_iters; the schedule state's count is the iteration index because the
    optimizer is re-init'ed per timestep)."""
    if cfg.lr_min is None:
        return optax.adam(cfg.lr)
    sched = optax.cosine_decay_schedule(cfg.lr, cfg.max_iters,
                                        alpha=cfg.lr_min / cfg.lr)
    return optax.adam(sched)


@partial(jax.jit, static_argnames=("cfg", "first_step"))
def _run_block(cfg: NoMLPConfig, params: RawParams, opt_state, active,
               prev_mixture, key, first_step: bool):
    """One jitted block of Adam iterations; returns accumulated grad stats for
    densification (test_no_mlp.py:149-155)."""
    opt = _make_opt(cfg)

    def step(carry, key):
        params, opt_state, grad_acc = carry
        k1, k2 = jax.random.split(key)
        samples = draw_samples(cfg, k1, params, active, first_step=first_step)
        time_samples = jax.random.uniform(k2, (cfg.n_samples,), cfg.dtype)

        if first_step:
            prev = None
        else:
            pm, pc, pv, pa = prev_mixture
            pout = eval_mixture(pm, pc, pv, samples, order=2, mask=pa)
            prev = jax.tree_util.tree_map(jax.lax.stop_gradient,
                                          (pout.u, pout.ux, pout.uxx))

        loss, grads = jax.value_and_grad(
            lambda p: _loss_fn(cfg, p, active, prev, samples, time_samples,
                               first_step))(params)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        grad_acc = jax.tree_util.tree_map(jnp.add, grad_acc, grads)
        return (params, opt_state, grad_acc), loss

    grad_acc = jax.tree_util.tree_map(jnp.zeros_like, params)
    keys = jax.random.split(key, cfg.block_iters)
    (params, opt_state, grad_acc), losses = jax.lax.scan(
        step, (params, opt_state, grad_acc), keys)
    return params, opt_state, grad_acc, jnp.mean(losses)


@partial(jax.jit, static_argnames=("cfg",))
def densify(cfg: NoMLPConfig, params: RawParams, opt_state, active,
            mean_grad_acc: jax.Array):
    """Prune + split with Adam-moment surgery (test_no_mlp.py:188-252).

    keep:   ||v|| > 0.01  and  sum(exp(raw_scaling)) < 0.5
    split:  mean-grad norm above mean + 1.6*std (the reference's ~90th quantile),
            displaced along the accumulated mean-gradient (1D variant,
            test_no_mlp_1d.py:219-225).
    Children land in free slots; their Adam moments are zeroed.
    """
    grad_norm = jnp.linalg.norm(mean_grad_acc, axis=-1)
    keep = ((jnp.linalg.norm(params.values, axis=-1) > 0.01)
            & (jnp.sum(jnp.exp(params.raw_scaling), axis=-1) < 0.5))
    keep = keep & active
    if cfg.min_keep > 0:
        # Collapse guard: when the criterion would keep fewer than min_keep,
        # keep the top min_keep active slots by value norm instead.  If fewer
        # than min_keep slots are active at all, the kth value is -inf and
        # the fallback keeps every active slot.
        vnorm = jnp.where(active, jnp.linalg.norm(params.values, axis=-1),
                          -jnp.inf)
        kth = jnp.sort(vnorm)[-cfg.min_keep]
        fallback = active & (vnorm >= kth)
        keep = jnp.where(jnp.sum(keep) >= cfg.min_keep, keep, fallback)

    g = jnp.where(active, grad_norm, jnp.nan)
    mu = jnp.nanmean(g)
    sd = jnp.nanstd(g)
    quant = mu + 1.6 * sd
    want = (grad_norm > quant) & keep

    # Splitting into a slot that was just pruned is fine: pruned slots are free.
    dest = compact_scatter(~active | ~keep, want)
    landed = jnp.zeros_like(active).at[dest].set(want, mode="drop")
    new_active = keep | landed

    child = params._replace(
        raw_means=params.raw_means + mean_grad_acc)

    def scatter(buf, child_buf):
        return buf.at[dest].set(child_buf, mode="drop")

    new_params = RawParams(*[scatter(b, cb) for b, cb in
                             zip(params, child)])

    # Adam-moment surgery: zero the moments of freshly (re)initialized slots.
    fresh = landed | (active & ~keep)

    def zero_rows(moment):
        return jax.tree_util.tree_map(
            lambda m: jnp.where(fresh.reshape((-1,) + (1,) * (m.ndim - 1)),
                                jnp.zeros_like(m), m), moment)

    new_opt_state = []
    for s in opt_state:
        if isinstance(s, optax.ScaleByAdamState):
            new_opt_state.append(s._replace(mu=zero_rows(s.mu),
                                            nu=zero_rows(s.nu)))
        else:
            new_opt_state.append(s)
    return new_params, tuple(new_opt_state), new_active


def solve_timestep(cfg: NoMLPConfig, params: RawParams, active,
                   prev_mixture, key, first_step: bool,
                   densify_every: Optional[int] = None):
    """Optimize one timestep to convergence (inner loop of SURVEY.md §3.3).

    Convergence mirrors the reference (test_no_mlp.py:84,157-163): block
    losses (means over ``block_iters`` iterations) feed a 5-block window;
    the IC fit (``first_step``) runs until the window's relative std drops
    below 0.1 (plateau — the IC loss floor is representation-limited, not
    zero), dynamics steps until the window *mean* drops below ``tol``; both
    cap at ``max_iters`` iterations.  Densification additionally waits out
    ``cfg.warm_up_blocks`` (see NoMLPConfig).
    """
    opt = _make_opt(cfg)
    opt_state = opt.init(params)
    mean_grad_acc = jnp.zeros_like(params.raw_means)
    it = 0
    block = 0
    block_losses = []

    def converged() -> bool:
        window = block_losses[-5:]
        if first_step:
            if len(window) < 2:
                return False
            mean = float(np.mean(window))
            rel_std = float(np.std(window, ddof=1)) / mean if mean else 0.0
            return not np.isnan(rel_std) and rel_std <= 0.1
        return bool(window) and float(np.mean(window)) <= cfg.tol

    while it < cfg.max_iters and not converged():
        key, sub = jax.random.split(key)
        params, opt_state, grad_acc, loss_b = _run_block(
            cfg, params, opt_state, active, prev_mixture, sub, first_step)
        mean_grad_acc = mean_grad_acc + grad_acc.raw_means / cfg.block_iters
        block_losses.append(float(loss_b))
        it += cfg.block_iters
        block += 1
        if (densify_every and block % densify_every == 0
                and block > cfg.warm_up_blocks and not first_step):
            params, opt_state, active = densify(cfg, params, opt_state, active,
                                                mean_grad_acc)
            mean_grad_acc = jnp.zeros_like(params.raw_means)
    loss = float(np.mean(block_losses[-5:])) if block_losses else np.inf
    return params, active, loss


def solve(cfg: NoMLPConfig, key: jax.Array, n_timesteps: int,
          densify_every: Optional[int] = None):
    """Full outer loop over timesteps; returns the trajectory of mixtures."""
    params, active = init_params(cfg)
    trajectory = []
    prev_mixture = None
    for i in range(n_timesteps):
        key, sub = jax.random.split(key)
        params, active, loss = solve_timestep(
            cfg, params, active, prev_mixture, sub, first_step=(i == 0),
            densify_every=densify_every)
        means, conics, values = concrete(cfg, params)
        prev_mixture = (jax.lax.stop_gradient(means),
                        jax.lax.stop_gradient(conics),
                        jax.lax.stop_gradient(values), active)
        trajectory.append({"params": params, "active": active, "loss": loss})
    return trajectory
