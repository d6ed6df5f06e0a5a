#!/usr/bin/env python
"""Train the PN dynamics network on the full reference schedule and validate
the 50-step rollout against independent ground truth.

This is the reference's headline flow (main_pn.py:101-277 training,
279-484 rollout eval + Norm print) completed end-to-end:

  * burgers / diffusion: the rollout's rendered frames are compared per-step
    against the in-tree RK4 finite-difference solution started from the SAME
    rendered initial field (utils/fd.solve_fd_2d) — the role of
    ``burgers_double_gt.npy``.
  * test: the synthetic TEST dynamics have an analytic law — interior
    Gaussians move vertically at dy/dt = u/5 (model_pn.py:851) with u pushed
    to -sign(y) near the rim — so the rollout is scored by how well the
    learned per-step motion matches u/5.

Examples:
  python scripts/validate_pn.py --problem burgers --epochs 5000 --out results_burgers
  python scripts/validate_pn.py --problem test --epochs 5000 --out results_test --resume
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--problem", default="burgers",
                   choices=["burgers", "diffusion", "wave", "poisson", "test"])
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--width-mult", type=int, default=1,
                   help="network width multiplier (1 = reference sizes)")
    p.add_argument("--n-samples", type=int, default=1024)
    p.add_argument("--dt", type=float, default=1.0,
                   help="timestep size (the reference hardcodes 1.0, "
                        "main_pn.py:62; smaller steps are easier to learn "
                        "and the FD comparison uses the same dt)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-min", type=float, default=None,
                   help="cosine-decay the base lr to this value over training")
    p.add_argument("--loss-weight-floor", type=float, default=0.0,
                   help="floor on the per-step loss weight so late curriculum "
                        "steps keep learning (0.0 = reference semantics)")
    p.add_argument("--train-timesteps", type=int, default=30,
                   help="curriculum horizon (reference: 30, main_pn.py:94); "
                        "training to the full rollout length (e.g. 50) "
                        "suppresses late-step drift")
    p.add_argument("--split-epoch", type=int, default=10000,
                   help="epoch after which training-time adaptive prune/split "
                        "engages (main_pn.py:180; reference default 10000); "
                        "set >= --epochs to disable")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="if set (e.g. 0.999), keep an EMA of the params and "
                        "roll out with it")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="batch N whole epochs into one device dispatch "
                        "(bit-identical result; big win on high-latency "
                        "links; best dividing save_step)")
    p.add_argument("--adaptive-sampling", type=float, default=0.0,
                   help="fraction of collocation points drawn by "
                        "|grad u|-importance sampling (0.0 = reference "
                        "uniform)")
    p.add_argument("--noise-std", type=float, default=0.0,
                   help="robustness noise on interior u per training step "
                        "(0.0 = reference semantics)")
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = reference "
                        "semantics, no clipping)")
    p.add_argument("--skip-nonfinite", action="store_true",
                   help="skip optimizer updates whose gradients contain "
                        "NaN/Inf (off = reference semantics)")
    p.add_argument("--wave-psi-scale", type=float, default=1.0,
                   help="WAVE only: train/evolve in the (phi, psi/s) basis "
                        "(state channel 1 stores psi/s) so both channels "
                        "stay O(bump amplitude); rollout scoring converts "
                        "back to true psi units.  1.0 = reference semantics; "
                        "~30 matches the measured omega of the reference "
                        "bump (BENCHMARKS.md wave analysis)")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rollout-steps", type=int, default=50)
    p.add_argument("--rollout-split", nargs="?", type=int, const=-1,
                   default=None, metavar="N",
                   help="apply the training-time adaptive prune/split during "
                        "the eval rollout (eval-time densification; the "
                        "reference evolves with split=False).  Optional N "
                        "densifies only the first N steps — splitting to "
                        "capacity saturation degrades late steps")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--out", default="results_validate_pn")
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)

    import jax
    from pigs_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.models.model import ModelConfig, make_initial_state
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.pn import (TrainConfig, rollout, rollout_metrics,
                                   train)
    from pigs_tpu.utils.fd import solve_fd_2d

    problem = Problem[args.problem.upper()]
    cfg = ModelConfig.create(problem, IntegrationRule.TRAPEZOID,
                             nx=args.nx, ny=args.nx, d=2, scale=1.0,
                             capacity=args.capacity,
                             width_mult=args.width_mult)
    if args.wave_psi_scale != 1.0:
        if problem != Problem.WAVE:
            p.error("--wave-psi-scale only applies to --problem wave")
        cfg = cfg._replace(coeff=cfg.coeff._replace(
            wave_psi_scale=args.wave_psi_scale))
    tcfg = TrainConfig(n_epochs=args.epochs, n_samples=args.n_samples,
                       lr=args.lr, dt=args.dt, seed=args.seed,
                       lr_min=args.lr_min,
                       train_timesteps=args.train_timesteps,
                       loss_weight_floor=args.loss_weight_floor,
                       split_epoch=args.split_epoch,
                       ema_decay=args.ema_decay, noise_std=args.noise_std,
                       adaptive_sampling=args.adaptive_sampling,
                       clip_norm=args.clip_norm or None,
                       skip_nonfinite_updates=args.skip_nonfinite,
                       epochs_per_dispatch=args.epochs_per_dispatch)
    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "train.log")

    def log_fn(msg):
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(str(msg) + "\n")

    t0 = time.time()
    result = train(
        cfg, tcfg, checkpoint_dir=os.path.join(args.out, "checkpoints"),
        resume=args.resume, log_fn=log_fn)
    network, losses = result.network, result.training_loss
    params = result.params
    if result.ema_params is not None:
        log_fn("rolling out with EMA params")
        params = result.ema_params
    train_s = time.time() - t0
    log_fn(f"training wall-clock: {train_s:.1f} s "
           f"({args.epochs} epochs, capacity {cfg.capacity})")

    # ---------------------------------------------------------------- rollout
    densify = (False if args.rollout_split is None
               else True if args.rollout_split < 0 else args.rollout_split)
    frames, evo_time = rollout(cfg, network, params,
                               n_steps=args.rollout_steps, res=args.res,
                               densify=densify, dt=args.dt)
    log_fn(f"rollout: {args.rollout_steps} steps in {evo_time*1e3:.1f} ms")
    np.save(os.path.join(args.out, "rollout_frames.npy"), frames)

    summary = {"problem": args.problem, "epochs": args.epochs,
               "capacity": cfg.capacity, "train_s": train_s,
               "evo_time_s": evo_time, "rollout_split": densify,
               "dt": args.dt, "n_samples": args.n_samples,
               "ema_decay": args.ema_decay,
               "wave_psi_scale": args.wave_psi_scale,
               "final_loss": losses[-1] if losses else None}

    if problem in (Problem.BURGERS, Problem.DIFFUSION, Problem.WAVE):
        # frames: (steps, c, res, res), image layout (row = flipped y,
        # col = x).  FD layout: axis 0 = x, y ascending.
        if problem == Problem.WAVE:
            # Two-channel system (phi, psi); FD ground truth evolves both
            # (test_no_mlp.py:135-139 / model_pn.py:625-629 semantics).
            # The model's channel 1 holds psi/s — convert frames to true psi
            # units before the FD comparison so scores are physical.
            s = cfg.coeff.wave_psi_scale
            frames = frames.copy()
            frames[:, 1] *= s
            u0_fd = jnp.stack(
                [jnp.asarray(np.flipud(frames[0, ch]).T) for ch in range(2)],
                axis=-1)
            gt = np.asarray(solve_fd_2d(u0_fd, cfg.scale, tcfg.dt,
                                        args.rollout_steps, problem="wave"))
            gt_frames = np.stack(  # (steps+1, c, res, res) image layout
                [np.stack([np.flipud(g[..., ch].T) for ch in range(2)])
                 for g in gt])
            np.save(os.path.join(args.out, "fd_gt_frames.npy"), gt_frames)
            m = rollout_metrics(frames[:, 0], gt_frames[:, 0])
            m_psi = rollout_metrics(frames[:, 1], gt_frames[:, 1])
            summary.update(m)
            summary["mean_rel_norm_psi"] = m_psi["mean_rel_norm"]
            summary["per_step_rel_norm_psi"] = m_psi["per_step_rel_norm"]
        else:
            f0 = frames[0, 0]
            u0_fd = jnp.asarray(np.flipud(f0).T)
            gt = np.asarray(solve_fd_2d(u0_fd, cfg.scale, tcfg.dt,
                                        args.rollout_steps,
                                        problem=args.problem, nu=cfg.coeff.nu))
            gt_frames = np.stack([np.flipud(g.T) for g in gt])  # image layout
            np.save(os.path.join(args.out, "fd_gt_frames.npy"), gt_frames)
            m = rollout_metrics(frames[:, 0], gt_frames)
            summary.update(m)
        log_fn("per-step rel-L2 vs FD: "
               + " ".join(f"{v:.3f}" for v in m["per_step_rel_norm"]))
        log_fn(f"mean rel-L2 vs FD: {m['mean_rel_norm']:.4f}")
    elif problem == Problem.POISSON:
        # Analytic ground truth: the POISSON residual (pde.py; the reference's
        # branch crashes on an undefined `t`, model_pn.py:620-621) enforces
        # u_xx = 100*t*sin(pi*(x+1)) with u -> 0 on the boundary band; the
        # unique solution is u*(x,y,t) = -(100*t/pi^2)*sin(pi*(x+1)).
        # Frame k (state after k steps) is pulled by the TRAPEZOID rule toward
        # the forcing of BOTH adjacent step intervals (t=(k-1)*dt and k*dt),
        # so the midpoint time (k-1/2)*dt is the aligned target; the k*dt
        # score is recorded alongside.
        tx = np.linspace(-1.0, 1.0, args.res) * cfg.scale
        # gt[row, col] = f(x_col): constant along rows (image_samples layout).
        profile = np.tile(np.sin(np.pi * (tx + 1.0))[None, :], (args.res, 1))

        def gt_at(times):
            amp = -(100.0 * np.asarray(times) / np.pi ** 2)
            return amp[:, None, None] * profile[None]       # (T, res, res)

        steps = np.arange(args.rollout_steps)
        gt_mid = gt_at(np.maximum(steps - 0.5, 0.0) * tcfg.dt)
        gt_end = gt_at(steps * tcfg.dt)
        np.save(os.path.join(args.out, "fd_gt_frames.npy"), gt_mid)
        # Step 0 is the all-zero IC on both sides; score from step 1.
        m = rollout_metrics(frames[1:, 0], gt_mid[1:])
        m_end = rollout_metrics(frames[1:, 0], gt_end[1:])
        summary.update(m)
        summary["mean_rel_norm_t_end"] = m_end["mean_rel_norm"]
        summary["per_step_rel_norm_t_end"] = m_end["per_step_rel_norm"]
        log_fn("per-step rel-L2 vs analytic (midpoint time): "
               + " ".join(f"{v:.3f}" for v in m["per_step_rel_norm"]))
        log_fn(f"mean rel-L2 vs analytic: {m['mean_rel_norm']:.4f} "
               f"(t=k*dt alignment: {m_end['mean_rel_norm']:.4f})")
    else:  # TEST: analytic motion law dy = u/5 per step.
        from functools import partial
        from pigs_tpu.models.model import forward_step
        from pigs_tpu.models.state import MixtureState

        state = make_initial_state(cfg)
        step = jax.jit(partial(forward_step, cfg, network))
        dy_err, du_drift, ys, us = [], [], [], []
        for i in range(args.rollout_steps):
            new_state, deltas = step(params, state)
            mask = np.asarray(state.interior)
            dy = np.asarray(deltas.dmeans)[mask, 1]
            u = np.asarray(state.u)[mask, 0]
            dy_err.append(float(np.mean(np.abs(dy - u / 5.0))))
            du_drift.append(float(np.mean(np.abs(
                np.asarray(deltas.du)[mask, 0]))))
            ys.append(float(np.mean(np.asarray(state.means)[mask, 1])))
            us.append(float(np.mean(u)))
            state = new_state
        summary.update({
            "mean_abs_dy_minus_u_over_5": float(np.mean(dy_err)),
            "per_step_dy_err": dy_err,
            "mean_y_trajectory": ys,
            "mean_u_trajectory": us,
        })
        log_fn(f"TEST law |dy - u/5| per step: mean "
               f"{np.mean(dy_err):.5f}, max {np.max(dy_err):.5f}")
        log_fn("mean y trajectory: "
               + " ".join(f"{v:.3f}" for v in ys[::5]))

    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log_fn(json.dumps({k: v for k, v in summary.items()
                       if not isinstance(v, list)}))

    try:  # plots are best-effort: matplotlib is optional
        from pigs_tpu.utils.plotting import render_rollout_artifacts
        if losses:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig = plt.figure()
            plt.plot(losses)
            plt.yscale("log")
            plt.xlabel(f"epoch / {tcfg.log_step}")
            plt.ylabel("total loss")
            fig.savefig(os.path.join(args.out, "training_loss.png"))
            plt.close(fig)
        for w in render_rollout_artifacts(args.out):
            log_fn(f"wrote {w}")
    except Exception as e:
        log_fn(f"plotting skipped: {e}")
    return summary


if __name__ == "__main__":
    main()
