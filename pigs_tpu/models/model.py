"""Simulation model: initial conditions, timestep forward, and physics losses.

Functional redesign of the reference's ``Model`` (model_pn.py:302-923).  The class
held mutable Gaussian state, a stateful CUDA sampler, and Python lists of sample
tensors; here every piece is explicit data:

  * Gaussian state     -> :class:`pigs_tpu.models.state.MixtureState` (padded)
  * sampler            -> :func:`pigs_tpu.ops.mixture.eval_mixture` (pure)
  * u/ux/uxx sample lists -> a ``StepFields`` carried between timesteps (only the
    last two entries are ever read, model_pn.py:794-821)
  * losses             -> pure functions of (state, deltas, prev, curr)

so a whole training rollout is a ``lax.scan`` over timesteps.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pigs_tpu import gaussians
from pigs_tpu.models.dynamics import Deltas, DynamicsNetwork
from pigs_tpu.models.state import MixtureState, covariance_of, init_state, prune, split
from pigs_tpu.ops.aggregate import neighbor_mask
from pigs_tpu.ops.mixture import eval_mixture
from pigs_tpu.pde import (IntegrationRule, PDECoefficients, Problem, channels,
                          pde_rhs, pde_size, time_integrate)

__all__ = ["LossWeights", "ModelConfig", "StepFields", "Losses",
           "make_initial_state", "randomize_state", "sample_fields",
           "forward_step", "compute_loss", "make_network"]


class LossWeights(NamedTuple):
    """Per-problem loss weights (model_pn.py:312-329)."""

    pde: float
    bc: float
    conservation: float
    initial: float
    du: float
    dmean: float
    dtransform: float
    dscale: float

    @staticmethod
    def default(problem: Problem) -> "LossWeights":
        if problem == Problem.TEST:
            return LossWeights(pde=10.0, bc=2.0, conservation=0.5, initial=1.0,
                               du=4.0, dmean=4.0, dtransform=1.0, dscale=1.0)
        return LossWeights(pde=1.0, bc=1.0, conservation=0.1, initial=2.0,
                           du=1.0, dmean=2.0, dtransform=2.0, dscale=2.0)


class ModelConfig(NamedTuple):
    problem: Problem
    rule: IntegrationRule
    nx: int
    ny: int
    d: int
    scale: float
    capacity: int
    weights: LossWeights
    coeff: PDECoefficients
    dtype: jnp.dtype = jnp.float32
    width_mult: int = 1           # network width multiplier (1 = reference
                                  # sizes, model_pn.py:44-49; >1 is an opt-in
                                  # capacity knob this framework adds)
    split_criteria: str = "value"  # adaptive prune/split metric family:
                                  # "value" = the reference's Burgers-tuned
                                  # criteria (|u|>0.01 prune, value-space
                                  # time-derivative split, model_pn.py:700-764);
                                  # "vorticity" = NS-native criteria (prune on
                                  # closed-form peak vorticity contribution,
                                  # split on rendered vorticity
                                  # time-derivative) — this framework's
                                  # addition, d=2/c=2 only

    @property
    def channels(self) -> int:
        return channels(self.problem)

    @property
    def pde_size(self) -> int:
        return pde_size(self.problem)

    @property
    def period(self) -> Optional[float]:
        """Torus period for periodic problems (the reference wraps NS means by
        +-2.0 in Python, model_pn.py:689-693; we wrap in the kernel)."""
        return 2.0 if self.problem == Problem.NAVIER_STOKES else None

    @staticmethod
    def create(problem: Problem,
               rule: IntegrationRule = IntegrationRule.TRAPEZOID,
               nx: int = 20, ny: int = 20, d: int = 2, scale: float = 1.0,
               capacity: Optional[int] = None,
               dtype=jnp.float32, width_mult: int = 1,
               split_criteria: str = "value") -> "ModelConfig":
        if capacity is None:
            # Must cover the training-time domain-randomized ICs: the grid
            # edge is sampled in [15, 40) (main_pn.py:153), i.e. up to 39^2
            # interior Gaussians for d=2, plus <=100 boundary Gaussians and
            # split margin.  1664 = 13*128, the capacity of the committed
            # Burgers checkpoints.
            capacity = max(2 * nx * ny + 128,
                           1664 if d == 2 else 2 * 40 + 128)
        return ModelConfig(problem=problem, rule=rule, nx=nx, ny=ny, d=d,
                           scale=scale, capacity=capacity,
                           weights=LossWeights.default(problem),
                           coeff=PDECoefficients.default(problem), dtype=dtype,
                           width_mult=width_mult,
                           split_criteria=split_criteria)


def make_network(cfg: ModelConfig) -> DynamicsNetwork:
    return DynamicsNetwork(c=cfg.channels, d=cfg.d, pde_size=cfg.pde_size,
                           width_mult=cfg.width_mult)


def _boundary_gaussians(cfg: ModelConfig):
    """Fixed boundary Gaussians per problem (model_pn.py:377-421)."""
    d, scale, c = cfg.d, cfg.scale, cfg.channels
    dt = cfg.dtype
    if cfg.problem == Problem.NAVIER_STOKES:
        nb = 0
        empty = lambda k: jnp.zeros((0, k), dt)
        return empty(d), empty(d), empty(d * (d - 1) // 2), empty(c)
    if cfg.problem == Problem.TEST:
        nb = 50
        ones = jnp.ones(nb // 2, dt) * scale
        rng = jnp.linspace(-1, 1, nb // 2, dtype=dt) * scale
        means = jnp.concatenate([
            jnp.stack([rng, ones], axis=-1),     # top
            jnp.stack([rng, -ones], axis=-1),    # bottom
        ])
        u = jnp.concatenate([
            -jnp.ones((nb // 2, c), dt),
            jnp.ones((nb // 2, c), dt),
        ])
        scaling = jnp.ones((nb, d), dt) / nb * scale * 1.5
        transforms = jnp.zeros((nb, d * (d - 1) // 2), dt)
        return means, scaling, transforms, u
    nb = 100
    ones = jnp.ones(nb // 4, dt) * scale
    rng = jnp.linspace(-1, 1, nb // 4, dtype=dt) * scale
    means = jnp.concatenate([
        jnp.stack([-ones, rng], axis=-1),
        jnp.stack([ones, rng], axis=-1),
        jnp.stack([rng, -ones], axis=-1),
        jnp.stack([rng, ones], axis=-1),
    ])
    u = jnp.zeros((nb, c), dt)
    scaling = jnp.ones((nb, d), dt) / nb * scale
    transforms = jnp.zeros((nb, d * (d - 1) // 2), dt)
    return means, scaling, transforms, u


def _interior_grid(cfg: ModelConfig, n: int):
    """Regular n x n interior Gaussian grid with the reference's gaussian-bump IC
    (model_pn.py:338-372, randomize branch 454-471)."""
    d, scale, c = cfg.d, cfg.scale, cfg.channels
    dt = cfg.dtype
    t = jnp.linspace(-1, 1, n, dtype=dt) * scale
    gx, gy = jnp.meshgrid(t, t, indexing="ij")
    means = jnp.stack([gx, gy], axis=-1).reshape(-1, d)
    scaling = jnp.exp(jnp.full((n * n, d), -4.0, dt)) * scale / (n / 20.0)
    transforms = jnp.zeros((n * n, d * (d - 1) // 2), dt)

    if cfg.problem in (Problem.BURGERS, Problem.DIFFUSION):
        var = 0.1 * scale
        power = -0.5 * jnp.sum(means * means, axis=-1) / var
        u = (jnp.exp(power) / 3.0)[:, None]
    elif cfg.problem == Problem.WAVE:
        u = jnp.zeros((n * n, c), dt)
        idx = []
        for i in range(-2, 3):
            for j in range(-2, 3):
                idx.append((n // 2 + i) * n + n // 2 + j)
        # Channel 1 stores psi/s (PDECoefficients.wave_psi_scale; s=1.0
        # reproduces the reference's same-bump-in-both-channels IC,
        # model_pn.py:365-369).
        amp = jnp.asarray([0.2, 0.2 / cfg.coeff.wave_psi_scale], dt)
        u = u.at[jnp.asarray(idx)].set(amp)
    else:  # NAVIER_STOKES / POISSON / TEST interior defaults
        u = jnp.zeros((n * n, c), dt)
    return means, scaling, transforms, u


def make_initial_state(cfg: ModelConfig, n: Optional[int] = None) -> MixtureState:
    """Initial padded state with boundary + interior Gaussians.

    ``Problem.TEST`` places 6 unit-value Gaussians in a vertical line
    (model_pn.py:370-375).
    """
    n = n if n is not None else cfg.nx
    bm, bs, bt, bu = _boundary_gaussians(cfg)
    if cfg.problem == Problem.TEST:
        dtp = cfg.dtype
        nx, ny, d = cfg.nx, cfg.ny, cfg.d
        t = jnp.linspace(-1, 1, nx, dtype=dtp) * cfg.scale
        gx, gy = jnp.meshgrid(t, t, indexing="ij")
        grid = jnp.stack([gx, gy], axis=-1).reshape(-1, d)
        sl = slice((nx // 2 - 3) * ny + ny // 2, (nx // 2 + 3) * ny + ny // 2, ny)
        means = grid[sl]
        scaling = jnp.exp(jnp.full((6, d), -4.0, dtp)) * cfg.scale
        transforms = jnp.zeros((6, d * (d - 1) // 2), dtp)
        u = jnp.ones((6, cfg.channels), dtp)
    else:
        means, scaling, transforms, u = _interior_grid(cfg, n)
    return init_state(cfg.capacity, means, scaling, transforms, u,
                      bm, bs, bt, bu)


def _apply_ic_noise(cfg: ModelConfig, ks, state: MixtureState) -> MixtureState:
    """The reference's IC noise (model_pn.py:472-502) on interior slots."""
    interior = state.interior
    gate = interior[:, None].astype(cfg.dtype)
    noise_m = jax.random.normal(ks[0], state.means.shape, cfg.dtype) * 0.2
    means = state.means + noise_m * gate
    means = jnp.where(interior[:, None],
                      jnp.tanh(means / cfg.scale) * cfg.scale * 0.95, means)
    u = state.u + jax.random.normal(ks[1], state.u.shape, cfg.dtype) * 0.1 * gate
    scale_noise = jnp.exp(
        jax.random.normal(ks[2], state.scaling.shape, cfg.dtype) * 0.5)
    scaling = jnp.where(interior[:, None], state.scaling * scale_noise,
                        state.scaling)
    transforms = jnp.where(
        interior[:, None],
        jnp.tanh(jax.random.normal(ks[3], state.transforms.shape,
                                   cfg.dtype) * 0.3),
        state.transforms)
    return state._replace(means=means, u=u, scaling=scaling,
                          transforms=transforms)


def _randomize_test(cfg: ModelConfig, ks) -> MixtureState:
    """TEST randomization: move the 6-Gaussian line vertically, random value
    (model_pn.py:440-452)."""
    state = make_initial_state(cfg)
    interior = state.interior
    edge = jax.random.uniform(ks[0]) > 0.75
    y_edge = ((0.9 + jax.random.uniform(ks[1]) * 0.1)
              * jnp.where(jax.random.uniform(ks[2]) > 0.5, 1.0, -1.0))
    y_mid = (jax.random.uniform(ks[3]) * 2.0 - 1.0) * 0.9
    y = jnp.where(edge, y_edge, y_mid).astype(cfg.dtype)
    val = (jax.random.uniform(ks[4]) * 2.0 - 1.0).astype(cfg.dtype)
    means = jnp.where(interior[:, None],
                      state.means.at[:, 1].set(y), state.means)
    u = jnp.where(interior[:, None],
                  state.u.at[:, 0].set(val), state.u)
    return state._replace(means=means, u=u)


def randomize_state(cfg: ModelConfig, key: jax.Array, n: int) -> MixtureState:
    """Domain-randomized initial conditions (model_pn.py:439-502).

    For TEST: randomize the line's vertical position and value.  Otherwise:
    rebuild an ``n x n`` grid and add noise to means/u/scaling/transforms.
    """
    ks = jax.random.split(key, 8)
    if cfg.problem == Problem.TEST:
        return _randomize_test(cfg, ks)
    state = make_initial_state(cfg, n=n)
    return _apply_ic_noise(cfg, ks, state)


def grid_state_dynamic(cfg: ModelConfig, n: jax.Array,
                       n_max: int) -> MixtureState:
    """Noise-free n x n grid IC with a *traced* grid edge ``n`` over an
    ``n_max^2``-slot padded buffer.  The active rows equal
    ``make_initial_state(cfg, n)``'s exactly; slots >= n^2 are inactive.
    """
    d, scale, c = cfg.d, cfg.scale, cfg.channels
    dt = cfg.dtype
    bm, bs, bt, bu = _boundary_gaussians(cfg)
    nb = bm.shape[0]
    if nb + n_max * n_max > cfg.capacity:
        raise ValueError(
            f"capacity {cfg.capacity} < boundary {nb} + n_max^2 "
            f"{n_max * n_max}")

    n = jnp.asarray(n, jnp.int32)
    nf = n.astype(dt)
    s = jnp.arange(n_max * n_max)
    gi = jnp.minimum(s // n, n - 1)
    gj = jnp.minimum(s % n, n - 1)
    step = 2.0 / jnp.maximum(nf - 1.0, 1.0)
    gx = (-1.0 + gi.astype(dt) * step) * scale
    gy = (-1.0 + gj.astype(dt) * step) * scale
    means = jnp.stack([gx, gy], axis=-1)                       # (n_max^2, d)
    scaling = jnp.exp(jnp.full((n_max * n_max, d), -4.0, dt)) * (
        scale / (nf / 20.0))
    transforms = jnp.zeros((n_max * n_max, d * (d - 1) // 2), dt)

    if cfg.problem in (Problem.BURGERS, Problem.DIFFUSION):
        var = 0.1 * scale
        power = -0.5 * jnp.sum(means * means, axis=-1) / var
        u = jnp.tile((jnp.exp(power) / 3.0)[:, None], (1, c))
    elif cfg.problem == Problem.WAVE:
        center = (jnp.abs(gi - n // 2) <= 2) & (jnp.abs(gj - n // 2) <= 2)
        amp = jnp.asarray([0.2, 0.2 / cfg.coeff.wave_psi_scale], dt)
        u = jnp.where(center[:, None], amp[None, :],
                      jnp.zeros((n_max * n_max, c), dt))
    else:
        u = jnp.zeros((n_max * n_max, c), dt)

    cap = cfg.capacity
    pad = cap - nb - n_max * n_max
    interior_active = s < n * n
    active = jnp.concatenate([
        jnp.ones((nb,), bool), interior_active, jnp.zeros((pad,), bool)])
    boundary = jnp.arange(cap) < nb

    def assemble(b, x, fill=0.0):
        padding = jnp.full((pad,) + x.shape[1:], fill, dt)
        return jnp.concatenate([b, x, padding], axis=0)

    return MixtureState(
        means=assemble(bm, means),
        scaling=jnp.where(active[:, None], assemble(bs, scaling, 1.0),
                          jnp.ones((cap, d), dt)),
        transforms=assemble(bt, transforms),
        u=assemble(bu, u),
        active=active,
        boundary=boundary,
    )


def randomize_state_dynamic(cfg: ModelConfig, key: jax.Array, n: jax.Array,
                            n_max: int) -> MixtureState:
    """:func:`randomize_state` with a *traced* grid edge ``n`` — one XLA
    compile covers the whole randomization range n in [15, 40) instead of one
    compile per distinct n (the per-epoch recompiles dominated wall-clock)."""
    ks = jax.random.split(key, 8)
    if cfg.problem == Problem.TEST:
        return _randomize_test(cfg, ks)
    return _apply_ic_noise(cfg, ks, grid_state_dynamic(cfg, n, n_max))


class StepFields(NamedTuple):
    """Field samples at the collocation points for one timestep
    (the reference's ``u_samples``/``ux_samples``/... entries,
    model_pn.py:766-788)."""

    u: jax.Array                      # (m, c)
    ux: jax.Array                     # (m, d, c)
    uxx: jax.Array                    # (m, d, d, c)
    bc_u: jax.Array                   # (mb, c)
    w: Optional[jax.Array] = None     # (m,)       NS vorticity
    wx: Optional[jax.Array] = None    # (m, d)
    wxx: Optional[jax.Array] = None   # (m, d, d)


def sample_fields(cfg: ModelConfig, state: MixtureState, samples: jax.Array,
                  bc_samples: jax.Array) -> StepFields:
    """Sample the interior mixture at collocation + boundary points
    (``Model.sample``, model_pn.py:766-788)."""
    ns = cfg.problem == Problem.NAVIER_STOKES
    _, conics = covariance_of(state)
    mask = state.interior
    out = eval_mixture(state.means, conics, state.u, samples,
                       order=3 if ns else 2, mask=mask, period=cfg.period,
                       diff_samples=False)
    bc = eval_mixture(state.means, conics, state.u, bc_samples, order=0,
                      mask=mask, period=cfg.period, diff_samples=False)
    w = wx = wxx = None
    if ns:
        w = out.ux[:, 0, 1] - out.ux[:, 1, 0]
        wx = out.uxx[..., 0, 1] - out.uxx[..., 1, 0]
        wxx = out.uxxx[..., 0, 1] - out.uxxx[..., 1, 0]
    return StepFields(u=out.u, ux=out.ux, uxx=out.uxx, bc_u=bc.u,
                      w=w, wx=wx, wxx=wxx)


def forward_step(
    cfg: ModelConfig,
    network: DynamicsNetwork,
    params,
    state: MixtureState,
    t: float = 0.0,
) -> Tuple[MixtureState, Deltas]:
    """One dynamics timestep (``Model.forward``, model_pn.py:644-698).

    Per-Gaussian features are sampled at the Gaussian centers from the *full*
    mixture (boundaries included) under stop_gradient (the reference's no_grad
    block, model_pn.py:645-664), the network predicts deltas, and the state is
    updated with boundary-masked Euler increments.
    """
    ns = cfg.problem == Problem.NAVIER_STOKES
    full_cov, conics = covariance_of(state)
    n = state.capacity

    # NOTE: samples here ARE the means, but the whole block is stop_gradient'd
    # (the reference's no_grad, model_pn.py:645-664), so diff_samples=False is
    # safe.
    fields = eval_mixture(state.means, conics, state.u, state.means,
                          order=3 if ns else 2, mask=state.active,
                          period=cfg.period, diff_samples=False)
    fields = jax.tree_util.tree_map(
        lambda x: None if x is None else jax.lax.stop_gradient(x), fields,
        is_leaf=lambda x: x is None)

    if ns:
        wx = fields.uxx[..., 0, 1] - fields.uxx[..., 1, 0]
        wxx = fields.uxxx[..., 0, 1] - fields.uxxx[..., 1, 0]
        sample_pde = pde_rhs(cfg.problem, cfg.coeff, state.means, fields.u,
                             fields.ux, fields.uxx, wx, wxx, t=t).reshape(n, -1)
    else:
        sample_pde = pde_rhs(cfg.problem, cfg.coeff, state.means, fields.u,
                             fields.ux, fields.uxx, t=t).reshape(n, -1)

    sample_ux = fields.ux.reshape(n, -1)
    # Hessian diagonal only, per-dim concatenated (model_pn.py:664).
    diag = jnp.stack([fields.uxx[:, a, a, :] for a in range(cfg.d)], axis=1)
    sample_uxx = diag.reshape(n, -1)

    nbr = neighbor_mask(state.means, full_cov, active=state.active,
                        period=cfg.period)
    deltas = network.apply(
        params, state.means, full_cov, state.u,
        state.boundary.astype(cfg.dtype), fields.u, sample_ux, sample_uxx,
        sample_pde, state.active, nbr, cfg.period)

    gate = state.interior[:, None].astype(cfg.dtype)
    means = state.means + deltas.dmeans * gate
    scaling = state.scaling * jnp.exp(deltas.dscaling * gate)
    transforms = state.transforms + deltas.dtransforms * gate
    u = state.u + deltas.du * gate

    if cfg.period is not None:
        # Keep means inside the fundamental domain (model_pn.py:689-693).
        means = jnp.where(state.interior[:, None],
                          means - cfg.period * jnp.round(means / cfg.period),
                          means)

    new_state = state._replace(means=means, scaling=scaling,
                               transforms=transforms, u=u)
    return new_state, deltas


def _density_rank(cfg: ModelConfig, state: MixtureState, conics):
    """Reference density weighting: rank-normalized mixture density at the
    means, inverted so sparse regions weigh more (model_pn.py:735-744)."""
    ones = jnp.ones((state.capacity, 1), cfg.dtype)
    density = eval_mixture(state.means, conics, ones, state.means, order=0,
                           mask=state.active, period=cfg.period).u
    act = state.active[:, None]
    d_min = jnp.min(jnp.where(act, density, jnp.inf))
    d_max = jnp.max(jnp.where(act, density, -jnp.inf))
    return 1.0 - (density - d_min) / jnp.maximum(d_max, 1e-30)


def peak_vorticity_contribution(conics, u):
    """Closed-form peak |curl| of each Gaussian's own velocity term.

    For one term u_i * g_i(x), g_i(x) = exp(-1/2 (x-mu)^T A (x-mu)):
    w_i(x) = curl(u_i g_i) = c^T A (x-mu) * g_i with c = (u_y, -u_x), whose
    maximum over x is  e^{-1/2} * sqrt(c^T A c)  (substitute y = A^{1/2}x;
    |a^T y| e^{-|y|^2/2} peaks at |y|=1).  ``conics`` full ``(n, 2, 2)``
    (the :func:`covariance_of` convention).
    """
    cx, cy = u[:, 1], -u[:, 0]
    quad = (conics[:, 0, 0] * cx * cx + 2.0 * conics[:, 0, 1] * cx * cy
            + conics[:, 1, 1] * cy * cy)
    return jnp.exp(-0.5) * jnp.sqrt(jnp.maximum(quad, 0.0))


def adaptive_split(cfg: ModelConfig, state: MixtureState,
                   prev_state: MixtureState,
                   quantile: float = 0.98) -> MixtureState:
    """Prune weak Gaussians and split the fastest-changing ones.

    ``cfg.split_criteria == "value"`` (default, the reference's Burgers-tuned
    criteria, model_pn.py:700-764): prune ``|u| < 0.01``; split where the
    density-weighted squared VALUE time-derivative exceeds its 98th
    percentile.

    ``cfg.split_criteria == "vorticity"`` (NS-native, this framework's
    round-5 addition; d=2/c=2 velocity fields only): the reference criteria
    act on raw velocity values, but NS dynamics live in vorticity — a
    Gaussian with large |u| can contribute nothing to w (uniform translation)
    and vice versa.  Prune Gaussians whose closed-form peak vorticity
    contribution is < 1% of the strongest active one (scale-invariant analog
    of the absolute |u|>0.01 gate); split where the density-weighted squared
    VORTICITY time-derivative (rendered w = du_y/dx - du_x/dy at the means)
    exceeds its 98th percentile.
    """
    if cfg.split_criteria not in ("value", "vorticity"):
        raise ValueError(f"unknown split_criteria {cfg.split_criteria!r}")
    if cfg.split_criteria == "vorticity" and (cfg.d != 2 or cfg.channels != 2):
        raise ValueError("split_criteria='vorticity' needs a d=2 two-channel "
                         "velocity field (NS); got "
                         f"d={cfg.d}, c={cfg.channels}")
    _, conics0 = covariance_of(state)
    if cfg.split_criteria == "vorticity":
        p = peak_vorticity_contribution(conics0, state.u)
        p_max = jnp.max(jnp.where(state.active, p, -jnp.inf))
        keep = p > 0.01 * p_max
    else:
        keep = jnp.linalg.norm(jnp.abs(state.u), axis=-1) > 0.01
    state = prune(state, keep)

    _, conics = covariance_of(state)
    _, prev_conics = covariance_of(prev_state)
    density = _density_rank(cfg, state, conics)
    if cfg.split_criteria == "vorticity":
        now = eval_mixture(state.means, conics, state.u, state.means, order=1,
                           mask=state.active, period=cfg.period,
                           diff_samples=False)
        prev = eval_mixture(prev_state.means, prev_conics, prev_state.u,
                            state.means, order=1, mask=prev_state.active,
                            diff_samples=False, period=cfg.period)
        w_now = now.ux[:, 0, 1] - now.ux[:, 1, 0]
        w_prev = prev.ux[:, 0, 1] - prev.ux[:, 1, 0]
        metric = ((w_now - w_prev) ** 2)[:, None] * density
    else:
        u_now = eval_mixture(state.means, conics, state.u, state.means,
                             order=0, mask=state.active,
                             period=cfg.period).u
        u_prev = eval_mixture(prev_state.means, prev_conics, prev_state.u,
                              state.means, order=0, mask=prev_state.active,
                              period=cfg.period).u
        metric = ((u_now - u_prev) ** 2) * density
    metric = jax.lax.stop_gradient(metric)

    flat = jnp.where(state.interior[:, None], metric, jnp.nan)
    q = jnp.nanquantile(flat, quantile)
    indices = jnp.any(metric > q, axis=-1) & state.interior
    return split(state, indices)


class Losses(NamedTuple):
    pde: jax.Array
    bc: jax.Array
    conservation: jax.Array
    initial: jax.Array
    magnitude: jax.Array

    @property
    def total(self) -> jax.Array:
        return self.pde + self.bc + self.conservation + self.initial

    @property
    def weighted_total(self) -> jax.Array:
        # The reference sums the four weighted losses; magnitude_loss is returned
        # but not added to the optimized loss (main_pn.py:200).
        return self.total


def _masked_mean(x: jax.Array, mask: jax.Array) -> jax.Array:
    """Mean over rows where mask is True; 0 if no row qualifies."""
    w = mask.astype(x.dtype)
    while w.ndim < x.ndim:
        w = w[..., None]
    denom = jnp.sum(jnp.broadcast_to(w, x.shape))
    return jnp.sum(x * w) / jnp.maximum(denom, 1.0)


def compute_loss(
    cfg: ModelConfig,
    state: MixtureState,
    deltas: Deltas,
    prev: StepFields,
    curr: StepFields,
    samples: jax.Array,
    time_samples: jax.Array,
    t: float,
    dt: float,
    initial_fields: Optional[jax.Array] = None,
) -> Losses:
    """Physics-informed losses for one timestep (model_pn.py:790-907)."""
    w = cfg.weights
    problem = cfg.problem
    ns = problem == Problem.NAVIER_STOKES

    mixed = time_integrate(cfg.rule, time_samples,
                           (prev.u, prev.ux, prev.uxx), (curr.u, curr.ux, curr.uxx))
    u_s, ux, uxx = mixed
    if ns:
        wx, wxx = time_integrate(cfg.rule, time_samples,
                                 (prev.wx, prev.wxx), (curr.wx, curr.wxx))
        rhs = dt * pde_rhs(problem, cfg.coeff, samples, u_s, ux, uxx, wx, wxx,
                           t=t)
        wt = curr.w - prev.w
    else:
        rhs = dt * pde_rhs(problem, cfg.coeff, samples, u_s, ux, uxx, t=t)
        ut = curr.u - prev.u

    interior = state.interior
    zero = jnp.zeros((), cfg.dtype)
    pde_loss = zero
    bc_loss = zero
    conservation_loss = zero
    initial_loss = zero

    if problem in (Problem.DIFFUSION, Problem.BURGERS):
        pde_loss += jnp.mean((ut - rhs) ** 2)
    elif problem == Problem.POISSON:
        pde_loss += jnp.mean(rhs ** 2)
    elif problem == Problem.WAVE:
        pde_loss += 0.01 * jnp.mean((ut[..., 0] - rhs[..., 0]) ** 2)
        pde_loss += jnp.mean((ut[..., 1] - rhs[..., 1]) ** 2)
    elif ns:
        pde_loss += jnp.mean((ux[:, 0, 0] + ux[:, 1, 1]) ** 2)
        pde_loss += jnp.mean((wt - rhs) ** 2)
    elif problem == Problem.TEST:
        pde_loss += _masked_mean(
            (deltas.dmeans[:, 1] - state.u[:, 0] / 5.0) ** 2, interior)

    if problem == Problem.TEST:
        negative = interior & (state.means[:, 1] < -0.8)
        bc_loss += _masked_mean((state.u[:, 0] - 1.0) ** 2, negative)
        positive = interior & (state.means[:, 1] > 0.8)
        bc_loss += _masked_mean((state.u[:, 0] + 1.0) ** 2, positive)
    elif not ns:
        bc_loss += jnp.mean(curr.bc_u ** 2)

    if problem == Problem.TEST:
        conservation_loss += w.dmean * _masked_mean(deltas.dmeans[:, 0] ** 2,
                                                    interior)
        dmean_bar = (jnp.sum(deltas.dmeans * interior[:, None], axis=0)
                     / jnp.maximum(jnp.sum(interior), 1))
        conservation_loss += w.dmean * _masked_mean(
            (deltas.dmeans - dmean_bar[None, :]) ** 2, interior)
        y_bar = (jnp.sum(state.means[:, 1] * interior)
                 / jnp.maximum(jnp.sum(interior), 1))
        conservation_loss += w.dmean * _masked_mean(
            (state.means[:, 1] - y_bar) ** 2, interior)
        in_range = interior & (jnp.abs(state.means[:, 1]) < 0.8)
        conservation_loss += w.du * _masked_mean(
            (jnp.abs(state.u[:, 0]) - 1.0) ** 2, in_range)
        conservation_loss += w.du * _masked_mean(deltas.du ** 2, in_range)
    else:
        conservation_loss += w.dmean * _masked_mean(deltas.dmeans ** 2, interior)
        conservation_loss += w.du * _masked_mean(deltas.du ** 2, interior)
    conservation_loss += w.dscale * _masked_mean(deltas.dscaling ** 2, interior)
    conservation_loss += w.dtransform * _masked_mean(deltas.dtransforms ** 2,
                                                     interior)

    if initial_fields is not None:
        initial_loss += jnp.mean((prev.u - initial_fields) ** 2)

    magnitude_loss = jnp.mean((deltas.head_magnitudes - 1.0) ** 2)

    return Losses(pde=w.pde * pde_loss, bc=w.bc * bc_loss,
                  conservation=w.conservation * conservation_loss,
                  initial=w.initial * initial_loss, magnitude=magnitude_loss)
