"""PN training driver: epochs run, checkpoints save/restore, NS recon loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pigs_tpu.models.model import ModelConfig
from pigs_tpu.pde import IntegrationRule, Problem
from pigs_tpu.train.pn import (NSDataset, TrainConfig, rollout,
                               rollout_metrics, train)


def small_cfg(problem=Problem.TEST):
    return ModelConfig.create(problem, IntegrationRule.TRAPEZOID, nx=6, ny=6,
                              d=2, scale=1.0, capacity=120)


def test_train_saves_and_resumes(tmp_path):
    cfg = small_cfg()
    tcfg = TrainConfig(n_epochs=2, n_samples=64, log_step=1, save_step=1,
                       seed=0)
    ckpt = str(tmp_path / "ckpts")
    logs = []
    network, params, _, losses, _ = train(cfg, tcfg, checkpoint_dir=ckpt,
                                       log_fn=logs.append)
    assert len(losses) == 2

    # Resume continues from the saved epoch without retraining from scratch.
    tcfg2 = tcfg._replace(n_epochs=3)
    logs2 = []
    _, params2, _, losses2, _ = train(cfg, tcfg2, checkpoint_dir=ckpt,
                                   resume=True, log_fn=logs2.append)
    assert any("Resumed" in l for l in logs2)
    assert len(losses2) >= 3  # restored history + one new epoch


def test_rollout_densify_finite_and_grows_mixture():
    """rollout(densify=True) applies eval-time adaptive prune/split per step:
    frames stay finite and the evolved state path compiles under scan."""
    cfg = small_cfg()
    tcfg = TrainConfig(n_epochs=1, n_samples=64, log_step=1, seed=0,
                       train_timesteps=2)
    r = train(cfg, tcfg)
    frames, _ = rollout(cfg, r.network, r.params, n_steps=3, res=8)
    frames_d, _ = rollout(cfg, r.network, r.params, n_steps=3, res=8,
                          densify=True)
    assert np.isfinite(frames).all() and np.isfinite(frames_d).all()
    # Densified rollout starts from the same state: first frames agree.
    np.testing.assert_allclose(frames_d[0], frames[0], rtol=1e-6)
    # Step-limited densification: densify=0 is exactly the plain rollout,
    # densify=n_steps is exactly densify=True.
    frames_0, _ = rollout(cfg, r.network, r.params, n_steps=3, res=8,
                          densify=0)
    np.testing.assert_allclose(frames_0, frames, rtol=1e-6)
    frames_3, _ = rollout(cfg, r.network, r.params, n_steps=3, res=8,
                          densify=3)
    np.testing.assert_allclose(frames_3, frames_d, rtol=1e-6)


def test_abort_on_poisoned_params(tmp_path):
    """A NaN-poisoned run aborts after 3 consecutive all-zero-loss epochs
    instead of dispatching dead epochs to the end of the schedule (the
    reference's filter-only NaN handling loops forever, main_pn.py:183-192)."""
    from pigs_tpu.train.checkpoint import save_checkpoint
    from pigs_tpu.train.pn import init_training

    cfg = small_cfg()
    tcfg = TrainConfig(n_epochs=1, n_samples=64, log_step=1, seed=0,
                       train_timesteps=2)
    _, params, _, opt_state = init_training(cfg, tcfg)
    bad = jax.tree_util.tree_map(lambda x: jnp.full_like(x, jnp.nan), params)
    ckpt = str(tmp_path / "ckpts")
    save_checkpoint(ckpt, 1, bad, opt_state, [1.0])

    logs = []
    tcfg2 = tcfg._replace(n_epochs=20)
    r = train(cfg, tcfg2, checkpoint_dir=ckpt, resume=True,
              log_fn=logs.append)
    assert any("ABORT" in str(l) for l in logs)
    # Aborted well before the schedule's end (3-epoch streak + resume point).
    assert len(r.training_loss) <= 6

    # Opt-out restores reference semantics: all 20 epochs run.
    logs3 = []
    r3 = train(cfg, tcfg2._replace(abort_on_poisoned=False),
               checkpoint_dir=ckpt, resume=True, log_fn=logs3.append)
    assert not any("ABORT" in str(l) for l in logs3)
    assert len(r3.training_loss) >= 19


def test_poisson_training_and_time_threaded_rollout():
    """POISSON end-to-end smoke: training runs finitely, and rollout(dt=...)
    threads physical time into forward_step — the POISSON pde feature is
    t-dependent (pde.py; the reference's branch crashes on an undefined t,
    model_pn.py:620-621), so frames must differ between dt=0 and dt>0, while
    an autonomous problem's frames must be bit-identical."""
    # POISSON uses 100 boundary Gaussians (vs TEST's 50): needs more capacity.
    cfg = ModelConfig.create(Problem.POISSON, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=160)
    tcfg = TrainConfig(n_epochs=2, n_samples=64, log_step=1, seed=0,
                       train_timesteps=2, dt=0.1)
    r = train(cfg, tcfg)
    assert np.isfinite(np.asarray(r.training_loss)).all()
    frames_t, _ = rollout(cfg, r.network, r.params, n_steps=3, res=8, dt=0.1)
    frames_0, _ = rollout(cfg, r.network, r.params, n_steps=3, res=8, dt=0.0)
    assert np.isfinite(frames_t).all()
    # Frame 0 is rendered before any step at t=0: identical either way.
    np.testing.assert_allclose(frames_t[0], frames_0[0], rtol=1e-6)
    # Later frames see different pde features (t = i*dt): they must diverge.
    assert not np.allclose(frames_t[2], frames_0[2])

    # Omitting dt for the time-dependent problem must fail loudly rather
    # than silently freezing the forcing at t=0 (round-4 advisor finding).
    with pytest.raises(ValueError, match="POISSON"):
        rollout(cfg, r.network, r.params, n_steps=3, res=8)

    # Autonomous problem (TEST): dt threading is a no-op, bit-identical.
    cfg2 = small_cfg(Problem.TEST)
    r2 = train(cfg2, tcfg)
    a, _ = rollout(cfg2, r2.network, r2.params, n_steps=3, res=8, dt=0.1)
    b, _ = rollout(cfg2, r2.network, r2.params, n_steps=3, res=8, dt=0.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_rollout_metrics():
    frames = np.zeros((3, 4, 4))
    gt = np.ones((3, 4, 4))
    m = rollout_metrics(frames, gt)
    np.testing.assert_allclose(m["per_step_rel_norm"], 1.0)
    np.testing.assert_allclose(m["per_step_rel_initial_norm"], 1.0)
    m2 = rollout_metrics(gt, gt)
    np.testing.assert_allclose(m2["mean_rel_norm"], 0.0)
    np.testing.assert_allclose(m2["mean_rel_initial_norm"], 0.0)
    # Decaying GT: the per-step relative norm diverges, the initial-norm
    # metric stays fixed-scale.
    decay = np.stack([gt[0] * f for f in (1.0, 0.1, 0.01)])
    m3 = rollout_metrics(np.zeros_like(decay), decay)
    np.testing.assert_allclose(m3["per_step_rel_norm"], 1.0)
    np.testing.assert_allclose(m3["per_step_rel_initial_norm"],
                               [1.0, 0.1, 0.01])


def test_ns_training_with_dataset():
    """NS epoch with stored initializations + vorticity frames exercises the
    reconstruction loss (main_pn.py:142-149, 202-212)."""
    cfg = small_cfg(Problem.NAVIER_STOKES)
    K, N0, res, T = 2, 30, 16, 4
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 5)
    data = NSDataset(
        means=(jax.random.uniform(ks[0], (K, N0, 2)) * 2 - 1).astype(
            jnp.float32),
        u=jax.random.normal(ks[1], (K, N0, 2), jnp.float32) * 0.1,
        scaling=jnp.exp(jax.random.normal(ks[2], (K, N0, 2)) * 0.2 - 3.0
                        ).astype(jnp.float32),
        transforms=jnp.zeros((K, N0, 1), jnp.float32),
        frames=jax.random.normal(ks[3], (K, res, res, T), jnp.float32) * 0.1,
    )
    tcfg = TrainConfig(n_epochs=2, n_samples=64, log_step=1, seed=0)
    logs = []
    network, params, _, losses, _ = train(cfg, tcfg, ns_data=data,
                                       log_fn=logs.append)
    assert np.isfinite(losses).all()


def test_ns_epochs_per_dispatch_matches_loop():
    """NS datasets ride the multi-epoch scan: the chunked dispatch draws the
    stored-initialization index and gathers recon targets on device, with
    key streams matching the per-epoch host loop bit-for-bit."""
    cfg = small_cfg(Problem.NAVIER_STOKES)
    K, N0, res, T = 3, 30, 16, 4
    ks = jax.random.split(jax.random.PRNGKey(7), 4)
    data = NSDataset(
        means=(jax.random.uniform(ks[0], (K, N0, 2)) * 2 - 1).astype(
            jnp.float32),
        u=jax.random.normal(ks[1], (K, N0, 2), jnp.float32) * 0.1,
        scaling=jnp.exp(jax.random.normal(ks[2], (K, N0, 2)) * 0.2 - 3.0
                        ).astype(jnp.float32),
        transforms=jnp.zeros((K, N0, 1), jnp.float32),
        frames=jax.random.normal(ks[3], (K, res, res, T), jnp.float32) * 0.1,
    )
    base = dict(n_epochs=4, n_samples=64, seed=0, log_step=2,
                train_timesteps=3)
    r1 = train(cfg, TrainConfig(**base), ns_data=data)
    r2 = train(cfg, TrainConfig(**base, epochs_per_dispatch=2), ns_data=data)
    for a, b in zip(jax.tree_util.tree_leaves(r1.params),
                    jax.tree_util.tree_leaves(r2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r1.training_loss, r2.training_loss,
                               rtol=1e-4, atol=1e-6)


def test_nsdataset_recon_target_lookup():
    frames = jnp.arange(2 * 4 * 4 * 3, dtype=jnp.float32).reshape(2, 4, 4, 3)
    data = NSDataset(means=jnp.zeros((2, 1, 2)), u=jnp.zeros((2, 1, 2)),
                     scaling=jnp.ones((2, 1, 2)),
                     transforms=jnp.zeros((2, 1, 1)), frames=frames)
    samples = jnp.array([[-1.0, -1.0], [0.99, 0.99]])
    got = data.recon_target(1, 2, samples)
    # (-1,-1) -> pixel (0,0); (0.99,0.99) -> pixel (3,3).
    np.testing.assert_allclose(np.asarray(got),
                               [float(frames[1, 0, 0, 2]),
                                float(frames[1, 3, 3, 2])])


def test_split_epoch_wiring():
    """Past split_epoch, epochs run the adaptive prune/split path
    (main_pn.py:180) without shape or finiteness issues."""
    import optax
    from pigs_tpu.train.pn import init_training, train_epoch
    cfg = small_cfg()
    tcfg = TrainConfig(n_epochs=1, n_samples=64, split_epoch=0, seed=0)
    network, params, opt, opt_state = init_training(cfg, tcfg)
    params, opt_state, totals, cur, nst = train_epoch(
        cfg, tcfg, network, opt, params, opt_state, jax.random.PRNGKey(3),
        epoch=1, current_timesteps=2)
    assert np.isfinite(totals).all()


def test_checkpoint_roundtrip_with_opt_state(tmp_path):
    """save/restore round-trip: params + optimizer state + loss history
    survive exactly, with and without an opt_state template (the reference
    restores the optimizer too, main_pn.py:66-73)."""
    import optax
    from pigs_tpu.train.checkpoint import (latest_step, restore_checkpoint,
                                           save_checkpoint)

    params = {"w": jnp.arange(6.0).reshape(2, 3),
              "nested": {"b": jnp.array([1.5, -2.0])}}
    opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-3)
    opt_state = opt.init(params)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    _, opt_state = opt.update(grads, opt_state)  # non-trivial moments
    history = [3.0, 2.0, 1.0]

    d = str(tmp_path / "ck")
    save_checkpoint(d, 7, params, opt_state, history)
    assert latest_step(d) == 7

    # With an opt_state template: opt_state restored, everything matches.
    like = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    r = restore_checkpoint(d, like(params), like(opt_state))
    assert r.step == 7 and r.training_loss == history
    assert r.ema_params is None
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(r.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree_util.tree_leaves(opt_state),
                    jax.tree_util.tree_leaves(r.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # Without a template: opt_state stays None.
    r3 = restore_checkpoint(d, like(params))
    assert r3.step == 7 and r3.training_loss == history
    assert r3.opt_state is None and r3.ema_params is None
    for a, b in zip(jax.tree_util.tree_leaves(params),
                    jax.tree_util.tree_leaves(r3.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ema_and_noise_training():
    """TrainConfig.ema_decay keeps an EMA shadow of the params and
    TrainConfig.noise_std perturbs interior values per training step; both
    train finite, and the EMA differs from the raw final iterate."""
    cfg = small_cfg()
    tcfg = TrainConfig(n_epochs=3, n_samples=64, seed=0, log_step=1,
                       train_timesteps=4, ema_decay=0.5, noise_std=0.05)
    r = train(cfg, tcfg)
    assert r.ema_params is not None
    ema_leaves = jax.tree_util.tree_leaves(r.ema_params)
    assert all(np.isfinite(np.asarray(l)).all() for l in ema_leaves)
    diffs = [float(np.abs(np.asarray(a) - np.asarray(b)).max())
             for a, b in zip(ema_leaves,
                             jax.tree_util.tree_leaves(r.params))]
    assert max(diffs) > 0  # trailing average != final iterate
    assert all(np.isfinite(l) for l in r.training_loss)
    # Default config keeps reference semantics: no EMA.
    r0 = train(cfg, TrainConfig(n_epochs=1, n_samples=64, seed=0))
    assert r0.ema_params is None


def test_epochs_per_dispatch_matches_loop():
    """TrainConfig.epochs_per_dispatch batches whole epochs into one
    lax.scan dispatch with bit-matching key streams — the trained params
    must agree with the per-epoch host loop."""
    cfg = small_cfg()
    base = dict(n_epochs=4, n_samples=64, seed=0, log_step=2,
                train_timesteps=3)
    r1 = train(cfg, TrainConfig(**base))
    r2 = train(cfg, TrainConfig(**base, epochs_per_dispatch=2))
    for a, b in zip(jax.tree_util.tree_leaves(r1.params),
                    jax.tree_util.tree_leaves(r2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(r1.training_loss, r2.training_loss,
                               rtol=1e-4, atol=1e-6)
    # Chunked + EMA + noise composes and stays finite.
    r3 = train(cfg, TrainConfig(**base, epochs_per_dispatch=2,
                                ema_decay=0.7, noise_std=0.02))
    assert r3.ema_params is not None
    assert all(np.isfinite(np.asarray(l)).all()
               for l in jax.tree_util.tree_leaves(r3.ema_params))


def test_ema_checkpoint_roundtrip(tmp_path):
    """EMA params ride along in checkpoints and come back in
    RestoredCheckpoint.ema_params — including on a template-less restore
    (the variable-arity failure mode ADVICE r2 flagged)."""
    import optax
    from pigs_tpu.train.checkpoint import restore_checkpoint, save_checkpoint

    params = {"w": jnp.arange(4.0)}
    ema = {"w": jnp.arange(4.0) * 0.5}
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    d = str(tmp_path / "ck")
    save_checkpoint(d, 3, params, opt_state, [1.0], ema_params=ema)

    like = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    r = restore_checkpoint(d, like(params), like(opt_state))
    assert r.step == 3 and r.training_loss == [1.0]
    np.testing.assert_array_equal(np.asarray(r.ema_params["w"]),
                                  np.asarray(ema["w"]))
    np.testing.assert_array_equal(np.asarray(r.params["w"]),
                                  np.asarray(params["w"]))
    # Template-less restore still surfaces the EMA (no arity ambiguity).
    r2 = restore_checkpoint(d, like(params))
    assert r2.opt_state is None
    np.testing.assert_array_equal(np.asarray(r2.ema_params["w"]),
                                  np.asarray(ema["w"]))


def test_scan_epoch_matches_loop():
    """pn_epoch_scan produces the same per-step losses and parameters as the
    equivalent python loop of pn_step calls (VERDICT r1 item 7)."""
    from pigs_tpu.models.model import randomize_state, sample_fields
    from pigs_tpu.train.pn import init_training, pn_epoch_scan, pn_step
    from pigs_tpu.utils.sampling import (boundary_band_samples,
                                         collocation_samples)

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=160)
    tcfg = TrainConfig(n_samples=64, seed=0)
    network, params, opt, opt_state = init_training(cfg, tcfg)
    key = jax.random.PRNGKey(1)
    state0 = randomize_state(cfg, key, 6)
    samples = collocation_samples(key, 64, 2, 1.0, cfg.dtype)
    time_samples = jax.random.uniform(key, (64,), cfg.dtype)
    bc = boundary_band_samples(key, 64, 1.0, cfg.dtype)
    prev0 = sample_fields(cfg, state0, samples, bc)
    n_steps = 3
    lr = jnp.asarray(tcfg.lr, cfg.dtype)

    # Loop version.
    p_l, os_l, st, pv = params, opt_state, state0, prev0
    lw = jnp.ones((), cfg.dtype)
    loop_steps = []
    for i in range(n_steps):
        p_l, os_l, st, pv, losses, total, lw = pn_step(
            cfg, network, opt, p_l, os_l, st, pv, samples, time_samples, bc,
            lw, lr, tcfg.epsilon, jnp.asarray(i * tcfg.dt, cfg.dtype),
            tcfg.dt)
        loop_steps.append(np.asarray(jnp.stack(
            [losses.pde, losses.bc, losses.conservation, losses.initial,
             losses.magnitude, total])))

    # Scan version.
    p_s, os_s, _, _, per_step = pn_epoch_scan(
        cfg, network, opt, params, opt_state, state0, prev0, samples,
        time_samples, bc, lr, tcfg.epsilon, tcfg.dt, n_steps)

    np.testing.assert_allclose(np.asarray(per_step), np.stack(loop_steps),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(jax.tree_util.tree_leaves(p_l),
                    jax.tree_util.tree_leaves(p_s)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_loss_weight_floor_and_lr_schedule():
    """The training-quality knobs: the per-step loss weight never drops below
    the configured floor, and the cosine base-lr schedule hits its endpoints
    (defaults reproduce the reference semantics exactly)."""
    from pigs_tpu.models.model import randomize_state, sample_fields
    from pigs_tpu.train.pn import init_training, pn_step
    from pigs_tpu.utils.sampling import (boundary_band_samples,
                                         collocation_samples)

    tc = TrainConfig(lr=1e-3, lr_min=1e-5, n_epochs=101)
    assert abs(tc.base_lr_at(0) - 1e-3) < 1e-12
    assert abs(tc.base_lr_at(100) - 1e-5) < 1e-12
    assert tc.base_lr_at(50) < tc.base_lr_at(0)
    assert TrainConfig(lr=1e-3).base_lr_at(50) == 1e-3  # default: constant

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=160)
    tcfg = TrainConfig(n_samples=64, seed=0)
    network, params, opt, opt_state = init_training(cfg, tcfg)
    key = jax.random.PRNGKey(1)
    state = randomize_state(cfg, key, 6)
    samples = collocation_samples(key, 64, 2, 1.0, cfg.dtype)
    ts = jax.random.uniform(key, (64,), cfg.dtype)
    bc = boundary_band_samples(key, 64, 1.0, cfg.dtype)
    prev = sample_fields(cfg, state, samples, bc)
    lw = jnp.asarray(1e-3, cfg.dtype)  # already tiny
    out = pn_step(cfg, network, opt, params, opt_state, state, prev, samples,
                  ts, bc, lw, jnp.asarray(1e-3, cfg.dtype), tcfg.epsilon,
                  jnp.asarray(0.0, cfg.dtype), tcfg.dt,
                  loss_weight_floor=jnp.asarray(0.05, cfg.dtype))
    assert float(out[6]) >= 0.05


def test_initial_fields_loss_reachable():
    """The t=0 initial-condition loss (model_pn.py:884-890) is reachable from
    pn_step: passing initial_fields adds w.initial * MSE(prev.u, target) at
    gate 1.0 and nothing at gate 0.0."""
    from pigs_tpu.models.model import randomize_state, sample_fields
    from pigs_tpu.train.pn import init_training, pn_step
    from pigs_tpu.utils.sampling import (boundary_band_samples,
                                         collocation_samples)

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=160)
    tcfg = TrainConfig(n_samples=64, seed=0)
    network, params, opt, opt_state = init_training(cfg, tcfg)
    key = jax.random.PRNGKey(1)
    state = randomize_state(cfg, key, 6)
    samples = collocation_samples(key, 64, 2, 1.0, cfg.dtype)
    ts = jax.random.uniform(key, (64,), cfg.dtype)
    bc = boundary_band_samples(key, 64, 1.0, cfg.dtype)
    prev = sample_fields(cfg, state, samples, bc)
    target = prev.u + 0.5

    def run(gate):
        out = pn_step(cfg, network, opt, params, opt_state, state, prev,
                      samples, ts, bc, jnp.ones((), cfg.dtype),
                      jnp.asarray(0.0, cfg.dtype), tcfg.epsilon,
                      jnp.asarray(0.0, cfg.dtype), tcfg.dt,
                      initial_fields=target,
                      initial_gate=jnp.asarray(gate, cfg.dtype))
        return float(out[4].initial)

    expected = cfg.weights.initial * float(jnp.mean((prev.u - target) ** 2))
    np.testing.assert_allclose(run(1.0), expected, rtol=1e-5)
    assert run(0.0) == 0.0


def test_fno_convert_to_nsdataset_and_train(tmp_path):
    """The full NS data pipeline (VERDICT r1 item 4): FNO-format .npy ->
    curl-fit converter -> NSDataset .npz -> one training epoch with the
    reconstruction loss (the reference's main_pn.py:36-49 chain)."""
    from pigs_tpu.train.ns_data import convert_fno, load_fno

    # Synthetic FNO file: raw layout (T, res, res, N).
    T, res, N = 3, 16, 2
    rng = np.random.default_rng(0)
    xs = np.linspace(-1, 1, res)
    gx, gy = np.meshgrid(xs, xs, indexing="xy")
    base = np.sin(np.pi * gx) * np.cos(np.pi * gy)
    raw = np.stack([[base * (1 + 0.1 * t + 0.2 * k) for t in range(T)]
                    for k in range(N)])                    # (N, T, res, res)
    raw = np.transpose(raw, (1, 2, 3, 0)).astype(np.float32)
    fno_path = str(tmp_path / "fno.npy")
    np.save(fno_path, raw)

    assert load_fno(fno_path).shape == (N, res, res, T)

    out = str(tmp_path / "ns_data.npz")
    logs = []
    convert_fno(fno_path, out, count=2, nx=5, iters=200, log_fn=logs.append)
    data = NSDataset.load(out)
    assert data.means.shape == (2, 25, 2)
    assert data.frames.shape == (2, res, res, T)
    assert np.isfinite(np.asarray(data.u)).all()

    cfg = ModelConfig.create(Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID,
                             nx=5, ny=5, d=2, scale=1.0, capacity=64)
    tcfg = TrainConfig(n_epochs=1, n_samples=64, log_step=1, seed=0)
    network, params, _, losses, _ = train(cfg, tcfg, ns_data=data,
                                       log_fn=logs.append)
    assert np.isfinite(losses).all()


def test_importance_sampling_concentrates_on_gradients():
    """adaptive_sampling draws collocation points preferentially where
    |grad u| is large, and training runs with it enabled (both the per-epoch
    and the multi-epoch-dispatch paths)."""
    from pigs_tpu.models.model import ModelConfig, make_initial_state
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.pn import TrainConfig, importance_samples, train

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=160)
    state = make_initial_state(cfg)
    # The burgers IC bump is centered at the origin: importance samples must
    # land closer to it than uniform ones on average.
    key = jax.random.PRNGKey(0)
    imp = importance_samples(cfg, key, 256, state, frac=1.0)
    uni = importance_samples(cfg, key, 256, state, frac=0.0)
    r_imp = float(jnp.mean(jnp.linalg.norm(imp, axis=-1)))
    r_uni = float(jnp.mean(jnp.linalg.norm(uni, axis=-1)))
    assert imp.shape == uni.shape == (256, 2)
    assert r_imp < r_uni - 0.1

    for epd in (1, 2):
        tcfg = TrainConfig(n_epochs=2, n_samples=64, seed=0,
                           adaptive_sampling=0.5, epochs_per_dispatch=epd,
                           log_step=1)
        result = train(cfg, tcfg, log_fn=lambda *_: None)
        assert np.isfinite(result.training_loss).all()


def test_split_epoch_scan_matches_loop():
    """Past split_epoch, the scanned epoch (adaptive split inside lax.scan)
    must reproduce the host-loop reference implementation exactly."""
    from pigs_tpu.models.model import ModelConfig
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.pn import TrainConfig, init_training, train_epoch

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=200)
    tcfg = TrainConfig(n_epochs=4, n_samples=64, seed=0, split_epoch=0,
                       train_timesteps=4, bootstrap_rate=1, dt=0.5)
    network, params, opt, opt_state = init_training(cfg, tcfg)
    key = jax.random.PRNGKey(7)
    epoch, cur_ts = 3, 5   # epoch > split_epoch -> split regime

    out_scan = train_epoch(cfg, tcfg, network, opt, params, opt_state, key,
                           epoch, cur_ts)
    out_loop = train_epoch(cfg, tcfg, network, opt, params, opt_state, key,
                           epoch, cur_ts, _force_loop=True)
    p_s, _, totals_s, ts_s, n_s = out_scan
    p_l, _, totals_l, ts_l, n_l = out_loop
    assert n_s == n_l and ts_s == ts_l
    # Same math, two compilations: totals agree to f32 fusion-reordering
    # noise (~2e-6 relative, measured).  Per-parameter agreement is bounded
    # by the Adam update scale instead — normalized updates g/(sqrt(v)+eps)
    # amplify tiny gradient noise on near-zero entries to O(lr) — so the
    # param check only rules out semantic divergence (which compounds to
    # >> lr over 4 steps, e.g. a flipped split decision).
    np.testing.assert_allclose(totals_s, totals_l, rtol=1e-4, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_s),
                    jax.tree_util.tree_leaves(p_l)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-2, atol=3e-3)


def test_multi_epoch_dispatch_through_split_regime():
    """epochs_per_dispatch > 1 keeps working past split_epoch (split runs
    inside the scanned epochs instead of forcing the per-epoch path)."""
    from pigs_tpu.models.model import ModelConfig
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.pn import TrainConfig, train

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=6, ny=6, d=2, scale=1.0, capacity=200)
    tcfg = TrainConfig(n_epochs=4, n_samples=64, seed=0, split_epoch=1,
                       train_timesteps=3, bootstrap_rate=1, dt=0.5,
                       epochs_per_dispatch=2, log_step=1)
    result = train(cfg, tcfg, log_fn=lambda *_: None)
    assert len(result.training_loss) == 4
    assert np.isfinite(result.training_loss).all()


@pytest.mark.parametrize("name,problem,clip,ema", [
    ("burgers_dt01_ckpt_30000", Problem.BURGERS, None, False),
    ("burgers_ns4096_ema2_ckpt_30000", Problem.BURGERS, 1.0, True),
    ("ns_vorttrain_ckpt_20000", Problem.NAVIER_STOKES, 1.0, True),
])
def test_committed_checkpoints_restore(name, problem, clip, ema):
    """The committed checkpoints restore into the network's parameter tree and
    the recipe's optimizer state: same paths, shapes and dtypes, finite."""
    import os
    from pigs_tpu.train.checkpoint import load_checkpoint_file
    from pigs_tpu.train.pn import init_training

    cfg = ModelConfig.create(problem, IntegrationRule.TRAPEZOID, nx=20, ny=20,
                             capacity=640)
    _, params, _, opt_state = init_training(cfg,
                                            TrainConfig(clip_norm=clip))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", name + ".npz")
    r = load_checkpoint_file(path, params, opt_state)
    assert r.step == int(name.rsplit("_", 1)[1])
    assert len(r.training_loss) > 0
    assert (r.ema_params is not None) == ema
    for restored, like in ((r.params, params), (r.opt_state, opt_state)):
        assert (jax.tree_util.tree_structure(restored)
                == jax.tree_util.tree_structure(like))
        for a, b in zip(jax.tree_util.tree_leaves(restored),
                        jax.tree_util.tree_leaves(like)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert np.isfinite(a).all()


def test_checkpoint_keeps_newest_three(tmp_path):
    """Only the newest MAX_TO_KEEP steps stay on disk; the latest restores."""
    import os
    from pigs_tpu.train.checkpoint import (MAX_TO_KEEP, latest_step,
                                           restore_checkpoint,
                                           save_checkpoint)
    params = {"w": jnp.arange(3.0)}
    d = str(tmp_path / "ck")
    for step in (1, 2, 3, 4, 5):
        save_checkpoint(d, step, {"w": params["w"] * step}, None, [step])
    assert sorted(os.listdir(d)) == [f"ckpt_{s}.npz" for s in (3, 4, 5)]
    assert MAX_TO_KEEP == 3 and latest_step(d) == 5
    r = restore_checkpoint(d, params)
    np.testing.assert_array_equal(np.asarray(r.params["w"]),
                                  np.arange(3.0) * 5)
    assert r.opt_state is None and r.training_loss == [5.0]
