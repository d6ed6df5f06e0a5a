#!/usr/bin/env python
"""End-to-end Navier-Stokes validation on physically-real data.

The reference's NS flow (main_pn.py:36-49, 142-149, 202-212) trains the PN
dynamics network from per-trajectory curl-fitted Gaussian initializations
with a vorticity-reconstruction loss against stored FNO dataset frames.
This script runs that flow with data generated by the IN-TREE pseudo-spectral
solver (`pigs_tpu.utils.fd.solve_ns_2d`) — the same unforced vorticity
dynamics the model's PDE residual penalizes (model_pn.py:630-632) — so the
rollout can be scored against independent spectral ground truth:

  1. generate: random band-limited vorticity ICs -> spectral solve ->
     FNO-format (T, res, res, N) .npy            [pigs_tpu.train.ns_data]
  2. convert: curl-fit frame 0 of each trajectory -> NSDataset .npz
     (test_initialize.py "f" mode)
  3. train: PN training with the recon loss (main_pn.py:202-212)
  4. rollout: evolve the held-out trajectory's curl-fit init, render
     vorticity (w = d(u_y)/dx - d(u_x)/dy) per step, compare per-step
     rel-L2 against the solver frames.

Example:
  python scripts/validate_ns.py --n-traj 4 --epochs 5000 --out results_ns
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n-traj", type=int, default=4,
                   help="trajectories to generate/fit (last one held out "
                        "from training when >1)")
    p.add_argument("--steps", type=int, default=50,
                   help="dataset frames per trajectory (reference: T=50)")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--nu", type=float, default=1e-3)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--nx", type=int, default=20,
                   help="curl-fit grid edge (reference 'small' fits)")
    p.add_argument("--fit-iters", type=int, default=2000)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--n-samples", type=int, default=1024)
    p.add_argument("--train-timesteps", type=int, default=30)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-min", type=float, default=None)
    p.add_argument("--loss-weight-floor", type=float, default=0.0)
    p.add_argument("--clip-norm", type=float, default=1.0,
                   help="global-norm gradient clipping (the NS residual "
                        "spikes 3-4 orders of magnitude mid-curriculum and "
                        "one unclipped spike NaN-poisons the run; 0 = "
                        "reference semantics, no clipping)")
    p.add_argument("--skip-nonfinite", action="store_true", default=True,
                   help="skip optimizer updates whose gradients contain "
                        "NaN/Inf (--no-skip-nonfinite = reference semantics)")
    p.add_argument("--no-skip-nonfinite", dest="skip_nonfinite",
                   action="store_false")
    p.add_argument("--epochs-per-dispatch", type=int, default=1,
                   help="batch this many whole epochs into one device "
                        "dispatch (NS stored initializations are drawn by a "
                        "traced index inside the scan)")
    p.add_argument("--split-epoch", type=int, default=10000,
                   help="epoch after which training-time adaptive prune/split "
                        "engages (main_pn.py:180; reference default 10000). "
                        "Set >= --epochs to disable: the Burgers-tuned "
                        "prune/split criteria destabilize NS training — the "
                        "PDE residual jumps ~20x once the split regime "
                        "starts (measured, results_ns_r4b/train.log)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="maintain an EMA of the network params and roll out "
                        "with it (off = reference semantics)")
    p.add_argument("--split-criteria", default="value",
                   choices=["value", "vorticity"],
                   help="adaptive prune/split metric family: 'value' = the "
                        "reference's Burgers-tuned criteria "
                        "(model_pn.py:700-764); 'vorticity' = NS-native "
                        "(prune on peak vorticity contribution, split on "
                        "vorticity time-derivative)")
    p.add_argument("--rollout-split", nargs="?", type=int, const=-1,
                   default=None, metavar="N",
                   help="apply adaptive prune/split (per --split-criteria) "
                        "during the eval rollout; optional N densifies only "
                        "the first N steps (reference evolves with "
                        "split=False, main_pn.py:448)")
    p.add_argument("--ckpt-dir", default=None,
                   help="restore checkpoints from this directory instead of "
                        "<out>/checkpoints (e.g. results_ns_r4c/checkpoints "
                        "for rollout-only re-evaluation with --resume and "
                        "--epochs equal to the stored count)")
    p.add_argument("--rollout-steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default="results_ns")
    p.add_argument("--ns-data", default=None, metavar="PATH",
                   help="shared dataset path (e.g. artifacts/ns_data_8traj"
                        ".npz); reused if it exists, written there if not. "
                        "Default: <out>/ns_data.npz per-run (round-4 runs "
                        "committed three byte-identical copies that way)")
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)

    import jax
    from pigs_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from functools import partial

    from pigs_tpu.models.model import ModelConfig, covariance_of, forward_step
    from pigs_tpu.ops.mixture import eval_mixture
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.ns_data import convert_fno, generate_fno
    from pigs_tpu.train.pn import (NSDataset, TrainConfig, rollout_metrics,
                                   train)

    os.makedirs(args.out, exist_ok=True)
    log_path = os.path.join(args.out, "train.log")

    def log_fn(msg):
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(str(msg) + "\n")

    # ------------------------------------------------------------ 1. generate
    fno_path = os.path.join(args.out, "ns_fno.npy")
    npz_path = args.ns_data or os.path.join(args.out, "ns_data.npz")
    if not os.path.exists(fno_path) and not os.path.exists(npz_path):
        generate_fno(fno_path, n_traj=args.n_traj, res=args.res,
                     steps=args.steps, dt=args.dt, nu=args.nu,
                     seed=args.seed, log_fn=log_fn)

    # ------------------------------------------------------------- 2. convert
    if not os.path.exists(npz_path):
        t0 = time.time()
        convert_fno(fno_path, npz_path, nx=args.nx, iters=args.fit_iters,
                    seed=args.seed, log_fn=log_fn)
        log_fn(f"curl-fit conversion: {time.time() - t0:.1f} s")
    data = NSDataset.load(npz_path)
    # Trajectory count comes from the (possibly pre-existing) dataset itself,
    # not the CLI flag — a cached ns_data.npz wins over --n-traj.
    k_traj = int(data.means.shape[0])
    if k_traj != args.n_traj:
        log_fn(f"note: {npz_path} holds {k_traj} trajectories "
               f"(--n-traj {args.n_traj} ignored; delete the file to "
               f"regenerate)")
    # Hold out the last trajectory for rollout scoring when we have spares.
    train_data = data
    eval_index = 0
    if k_traj > 1:
        train_data = NSDataset(*(x[:-1] for x in data))
        eval_index = k_traj - 1

    # --------------------------------------------------------------- 3. train
    cap = ((args.nx * args.nx + 127) // 128 + 1) * 128
    if args.rollout_split is not None:
        # Densification needs free padded capacity to split into.
        cap += 256
    cfg = ModelConfig.create(Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID,
                             nx=args.nx, ny=args.nx, d=2, scale=1.0,
                             capacity=cap, split_criteria=args.split_criteria)
    tcfg = TrainConfig(n_epochs=args.epochs, n_samples=args.n_samples,
                       lr=args.lr, dt=args.dt, seed=args.seed,
                       lr_min=args.lr_min,
                       train_timesteps=args.train_timesteps,
                       loss_weight_floor=args.loss_weight_floor,
                       split_epoch=args.split_epoch,
                       ema_decay=args.ema_decay,
                       clip_norm=args.clip_norm or None,
                       skip_nonfinite_updates=args.skip_nonfinite,
                       epochs_per_dispatch=args.epochs_per_dispatch)
    t0 = time.time()
    result = train(cfg, tcfg,
                   checkpoint_dir=(args.ckpt_dir
                                   or os.path.join(args.out, "checkpoints")),
                   resume=args.resume, ns_data=train_data, log_fn=log_fn)
    train_s = time.time() - t0
    log_fn(f"training wall-clock: {train_s:.1f} s")
    params = result.params
    if result.ema_params is not None:
        log_fn("rolling out with EMA params")
        params = result.ema_params

    # ------------------------------------------------------------- 4. rollout
    # Render vorticity on the pixel-center grid in the frames' [y, x] layout.
    res = args.res
    centers = (jnp.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy = jnp.meshgrid(centers, centers, indexing="ij")
    samples = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)  # (res*res, 2) [x,y]

    def render_w(state):
        _, conics = covariance_of(state)
        out = eval_mixture(state.means, conics, state.u, samples, order=1,
                           mask=state.active, period=cfg.period,
                           diff_samples=False)
        w = out.ux[:, 0, 1] - out.ux[:, 1, 0]   # d(u_y)/dx - d(u_x)/dy
        return w.reshape(res, res).T            # [x,y] -> [y,x]

    state = data.state_for(cfg, eval_index)
    step = jax.jit(partial(forward_step, cfg, result.network))
    render = jax.jit(render_w)
    densify_until = (0 if args.rollout_split is None
                     else args.rollout_steps if args.rollout_split < 0
                     else args.rollout_split)
    do_split = None
    if densify_until > 0:
        from pigs_tpu.models.model import adaptive_split
        do_split = jax.jit(partial(adaptive_split, cfg))
    frames = [np.asarray(render(state))]
    t0 = time.time()
    for i in range(args.rollout_steps):
        prev = state
        state, _ = step(params, state)
        if do_split is not None and i < densify_until:
            state = do_split(state, prev)
        frames.append(np.asarray(render(state)))
    evo_s = time.time() - t0
    frames = np.stack(frames)                   # (steps+1, res, res)
    np.save(os.path.join(args.out, "rollout_w.npy"), frames)

    gt = np.asarray(data.frames[eval_index]).transpose(2, 0, 1)  # (T+1,res,res)
    np.save(os.path.join(args.out, "gt_w.npy"), gt)
    m = rollout_metrics(frames, gt)
    fit_m = rollout_metrics(frames[:1], gt[:1])  # curl-fit quality at t=0
    log_fn("per-step vorticity rel-L2 vs spectral GT: "
           + " ".join(f"{v:.3f}" for v in m["per_step_rel_norm"]))
    log_fn(f"mean rel-L2: {m['mean_rel_norm']:.4f} "
           f"(t=0 curl-fit error {fit_m['mean_rel_norm']:.4f})")

    summary = {"problem": "navier_stokes", "epochs": args.epochs,
               "n_traj": k_traj, "held_out": k_traj > 1,
               "capacity": cfg.capacity, "dt": args.dt, "nu": args.nu,
               "train_s": train_s, "evo_s": evo_s,
               "n_samples": args.n_samples,
               "train_timesteps": args.train_timesteps,
               "ema_decay": args.ema_decay,
               "split_criteria": args.split_criteria,
               "split_epoch": args.split_epoch,
               "rollout_split": densify_until,
               "final_loss": (result.training_loss[-1]
                              if result.training_loss else None),
               "t0_fit_rel_norm": fit_m["mean_rel_norm"]}
    summary.update(m)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    log_fn(json.dumps({k: v for k, v in summary.items()
                       if not isinstance(v, list)}))

    try:
        from pigs_tpu.utils.plotting import render_rollout_artifacts
        for w in render_rollout_artifacts(args.out):
            log_fn(f"wrote {w}")
    except Exception as e:  # plots are best-effort after a long run
        log_fn(f"panel rendering failed: {e}")


if __name__ == "__main__":
    main()
