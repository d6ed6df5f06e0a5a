"""Gaussian-mixture solutions vs independent finite-difference ground truth.

The analog of the reference's test_numerical.py / test_numerical_2d.py (py-pde
comparisons), using the in-tree RK4 FD solvers.  Validates the reference
config 1 behavior: the 1D no-MLP Burgers solve must track the FD solution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pigs_tpu.ops.mixture import eval_mixture
from pigs_tpu.pde import Problem
from pigs_tpu.train.no_mlp import NoMLPConfig, concrete, solve
from pigs_tpu.utils.fd import solve_fd_1d, solve_fd_2d


def test_fd_diffusion_decays_mass_interior():
    xs = jnp.linspace(-1, 1, 101)
    u0 = jnp.exp(-2.0 * (xs * 2.5) ** 2)
    traj = solve_fd_1d(u0, scale=2.5, dt=0.1, steps=3, problem="diffusion")
    peaks = np.asarray(traj[:, 50])
    assert (np.diff(peaks) < 0).all()           # peak decays
    assert traj.shape == (4, 101)


def test_fd_burgers_advects_right():
    xs = jnp.linspace(-1, 1, 201) * 2.5
    u0 = jnp.exp(-2.0 * xs ** 2)
    traj = solve_fd_1d(u0, scale=2.5, dt=0.05, steps=4, problem="burgers",
                       nu=1.0 / (100.0 * np.pi))
    c0 = np.average(np.asarray(xs), weights=np.asarray(traj[0]) + 1e-9)
    c1 = np.average(np.asarray(xs), weights=np.asarray(traj[-1]) + 1e-9)
    assert c1 > c0 + 0.01                        # positive u advects right
    # Mass approximately conserved over short horizons (nu small).
    np.testing.assert_allclose(np.asarray(traj[-1]).sum(),
                               np.asarray(traj[0]).sum(), rtol=0.05)


def test_fd_wave_oscillates():
    xs = jnp.linspace(-1, 1, 101) * 2.5
    u0 = jnp.stack([jnp.exp(-2.0 * xs ** 2), jnp.zeros_like(xs)], axis=-1)
    traj = solve_fd_1d(u0, scale=2.5, dt=0.05, steps=4, problem="wave")
    assert np.isfinite(np.asarray(traj)).all()
    # Energy moves into the velocity channel.
    assert float(jnp.abs(traj[-1][:, 1]).max()) > 0.01


def test_no_mlp_burgers_tracks_fd():
    """The end-to-end physics check: mixture solve vs FD solve, 1D Burgers."""
    cfg = NoMLPConfig(problem=Problem.BURGERS, d=1, scale=2.5, n_init=25,
                      capacity=64, n_samples=128, dt=0.05, block_iters=50,
                      max_iters=600, tol=2e-5, dtype=jnp.float32)
    traj = solve(cfg, jax.random.PRNGKey(0), n_timesteps=4)

    res = 201
    xs = jnp.linspace(-1, 1, res, dtype=jnp.float32).reshape(-1, 1) * cfg.scale
    u0 = jnp.exp(-2.0 * xs[:, 0] ** 2)
    fd = solve_fd_1d(u0, scale=cfg.scale, dt=cfg.dt, steps=3,
                     problem="burgers", nu=cfg.nu)

    rels = []
    for i, snap in enumerate(traj):
        means, conics, values = concrete(cfg, snap["params"])
        u = eval_mixture(means, conics, values, xs, order=0,
                         mask=snap["active"]).u[:, 0]
        rel = (float(jnp.linalg.norm(u - fd[i]))
               / float(jnp.linalg.norm(fd[i])))
        rels.append(rel)
    # IC fit tight; subsequent steps track within a few percent.
    assert rels[0] < 0.05, rels
    assert max(rels) < 0.15, rels


def test_fd_2d_shapes_and_stability():
    res = 64
    t = jnp.linspace(-1, 1, res) * 2.5
    gx, gy = jnp.meshgrid(t, t, indexing="ij")
    u0 = jnp.exp(-(gx ** 2 + gy ** 2) / (2 * 0.125))
    traj = solve_fd_2d(u0, scale=2.5, dt=0.05, steps=2, problem="burgers",
                       nu=0.0318, substeps=200)
    assert traj.shape == (3, res, res)
    assert np.isfinite(np.asarray(traj)).all()
    c0 = np.average(np.asarray(gx), weights=np.asarray(traj[0]) + 1e-9)
    c1 = np.average(np.asarray(gx), weights=np.asarray(traj[-1]) + 1e-9)
    assert c1 > c0  # advection along +x


def test_fd_2d_wave_energy_exchange():
    """2D wave system (phi_t = psi, psi_t = 10 lap(phi) - 0.1 psi): a
    displacement bump converts into velocity and radiates outward; amplitudes
    stay finite and the damping term shrinks total energy."""
    res = 48
    t = jnp.linspace(-1, 1, res) * 2.5
    gx, gy = jnp.meshgrid(t, t, indexing="ij")
    phi0 = jnp.exp(-(gx ** 2 + gy ** 2) / (2 * 0.025))
    u0 = jnp.stack([phi0, jnp.zeros_like(phi0)], axis=-1)
    traj = solve_fd_2d(u0, scale=2.5, dt=0.1, steps=4, problem="wave",
                       substeps=400)
    assert traj.shape == (5, res, res, 2)
    assert np.isfinite(np.asarray(traj)).all()
    # velocity channel starts at zero and becomes non-trivial
    assert float(jnp.abs(traj[0, ..., 1]).max()) == 0.0
    assert float(jnp.abs(traj[-1, ..., 1]).max()) > 1e-3
    # the phi bump disperses: peak decreases
    assert float(traj[-1, ..., 0].max()) < float(traj[0, ..., 0].max())


def test_ns_2d_single_mode_exact_decay():
    """A single Fourier mode is an exact NS solution (its self-advection
    vanishes): w(t) = w0 exp(-nu |k|^2 t).  The pseudo-spectral solver must
    track it to near machine precision."""
    from pigs_tpu.utils.fd import solve_ns_2d

    res, scale, nu = 32, 1.0, 1e-3
    x = jnp.linspace(0, 2 * scale, res, endpoint=False)
    gx, gy = jnp.meshgrid(x, x, indexing="ij")
    kxm, kym = 2, 1
    k2 = ((2 * jnp.pi * kxm / (2 * scale)) ** 2
          + (2 * jnp.pi * kym / (2 * scale)) ** 2)
    w0 = jnp.sin(2 * jnp.pi * (kxm * gx + kym * gy) / (2 * scale))
    steps, dt = 5, 0.5
    traj = solve_ns_2d(w0, scale, dt, steps, nu=nu, substeps=20)
    exact = w0 * jnp.exp(-nu * k2 * dt * steps)
    err = float(jnp.max(jnp.abs(traj[-1] - exact))
                / jnp.max(jnp.abs(exact)))
    assert err < 1e-6
    # Spectral downsampling is exact for this band-limited field: the
    # coarse trajectory equals the exact solution on the coarse grid.
    coarse = solve_ns_2d(w0, scale, dt, steps, nu=nu, substeps=20,
                         res_out=16)
    exact_c = exact[::2, ::2]  # single low mode: stride IS exact here
    errc = float(jnp.max(jnp.abs(coarse[-1] - exact_c))
                 / jnp.max(jnp.abs(exact_c)))
    assert errc < 1e-5


def test_ns_2d_invariants_random_field():
    """Unforced 2D NS conserves mean vorticity exactly and dissipates
    enstrophy monotonically."""
    from pigs_tpu.utils.fd import random_vorticity, solve_ns_2d

    w0 = random_vorticity(jax.random.PRNGKey(0), 32)
    traj = solve_ns_2d(w0, 1.0, 0.5, 6, nu=1e-3, substeps=40)
    assert np.isfinite(np.asarray(traj)).all()
    assert abs(float(traj[-1].mean())) < 1e-10
    ens = [float((f ** 2).mean()) for f in traj[::2]]
    assert all(b < a for a, b in zip(ens, ens[1:]))


def test_generate_fno_convert_roundtrip(tmp_path):
    """generate_fno -> convert_fno -> NSDataset: layouts line up and the
    curl fit actually reduces its objective on the generated frame."""
    from pigs_tpu.train.ns_data import (convert_fno, fit_fno_trajectory,
                                        generate_fno)
    from pigs_tpu.train.pn import NSDataset

    fno = str(tmp_path / "ns.npy")
    npz = str(tmp_path / "ns.npz")
    generate_fno(fno, n_traj=2, res=24, steps=3, dt=0.2, seed=3,
                 gen_res=48, log_fn=lambda *_: None)
    raw = np.load(fno)
    assert raw.shape == (4, 24, 24, 2)
    convert_fno(fno, npz, nx=6, iters=60, log_fn=lambda *_: None)
    ds = NSDataset.load(npz)
    assert ds.means.shape[0] == 2 and ds.frames.shape == (2, 24, 24, 4)
    # recon_target indexes [y, x]: probing at the location of the frame's
    # max must return (close to) the frame's max value.
    frame = np.asarray(ds.frames[0, :, :, 0])
    iy, ix = np.unravel_index(np.argmax(frame), frame.shape)
    sample = jnp.asarray([[(ix + 0.5) / 24 * 2 - 1, (iy + 0.5) / 24 * 2 - 1]])
    got = float(ds.recon_target(0, 0, sample)[0])
    assert abs(got - frame[iy, ix]) < 1e-6
    # The curl fit converges on this frame: its final objective must be a
    # small fraction of the target's mean-square vorticity.
    *_, loss = fit_fno_trajectory(jnp.asarray(frame), nx=6, iters=200)
    assert np.isfinite(loss) and loss < 0.5 * float((frame ** 2).mean())
