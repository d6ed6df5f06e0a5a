#!/usr/bin/env python
"""20-timestep 2D no-MLP solve validated against the in-tree FD solution
(VERDICT r1 item 5; the reference's test_no_mlp.py:70-326 flow, which runs 20
timesteps of the 2D solve with densification but never compares against an
independent solver).

Per timestep the Gaussian field is rendered on a grid and compared to a
``solve_fd_2d`` trajectory started from the *rendered* t=0 field, mirroring
the 1D validation recorded in BENCHMARKS.md.

Examples:
  python scripts/validate_no_mlp_2d.py --problem burgers --timesteps 20
  python scripts/validate_no_mlp_2d.py --problem wave --timesteps 20
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
                   choices=["diffusion", "burgers", "wave"])
    p.add_argument("--scale", type=float, default=2.5)
    p.add_argument("--n-init", type=int, default=20)
    p.add_argument("--capacity", type=int, default=1024)
    p.add_argument("--timesteps", type=int, default=20)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--n-samples", type=int, default=1024)
    p.add_argument("--max-iters", type=int, default=5000)
    p.add_argument("--densify-every", type=int, default=3,
                   help="densify every N blocks (test_no_mlp.py "
                        "densification_step = 3*log_step+1); 0 = off")
    p.add_argument("--warm-up-blocks", type=int, default=300,
                   help="blocks before densification may fire within a "
                        "timestep.  Default 300 = the reference's "
                        "warm_up=100 densification periods "
                        "(test_no_mlp.py:30-32,188), which its 5000-iter "
                        "cap never reaches — i.e. reference semantics = "
                        "no densification in practice")
    p.add_argument("--min-keep", type=int, default=0,
                   help="pruning floor: never leave fewer than this many "
                        "active Gaussians (0 = reference semantics)")
    p.add_argument("--active-sampling", type=float, default=0.0,
                   help="fraction of collocation samples drawn around the "
                        "active Gaussians (0 = reference's uniform sampling)")
    p.add_argument("--lr-min", type=float, default=None,
                   help="cosine-decay the per-step Adam lr from 1e-2 to this "
                        "over max_iters (None = reference's constant lr; see "
                        "NoMLPConfig.lr_min)")
    p.add_argument("--init-raw-scaling", type=float, default=-5.0,
                   help="initial log-variance (test_no_mlp.py:42 uses -5.0 "
                        "for d=2; the 1D reference uses -4.0)")
    p.add_argument("--pad-domain", type=float, default=1.0,
                   help="run the FD ground truth on a domain this many times "
                        "wider than [-scale, scale]^2 and compare on the "
                        "central crop.  The mixture solve is free-space (no "
                        "boundary condition); the FD solver's Dirichlet walls "
                        "reflect outgoing waves back in, which invalidates "
                        "the comparison once the front reaches the boundary "
                        "(WAVE: speed sqrt(10), hits the wall by t~0.8).  "
                        ">1 pads the GT so the crop stays reflection-free")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import jax
    from pigs_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.ops.mixture import eval_mixture
    from pigs_tpu.pde import Problem
    from pigs_tpu.train.no_mlp import NoMLPConfig, concrete, solve
    from pigs_tpu.utils.fd import solve_fd_2d
    from pigs_tpu.utils.sampling import grid_samples

    out_dir = args.out or f"results_no_mlp_2d_{args.problem}"
    os.makedirs(out_dir, exist_ok=True)

    problem = Problem[args.problem.upper()]
    cfg = NoMLPConfig(problem=problem, d=2, scale=args.scale,
                      n_init=args.n_init, capacity=args.capacity,
                      n_samples=args.n_samples, dt=args.dt,
                      max_iters=args.max_iters, min_keep=args.min_keep,
                      warm_up_blocks=args.warm_up_blocks,
                      init_raw_scaling=args.init_raw_scaling,
                      lr_min=args.lr_min,
                      active_sampling=args.active_sampling)

    t0 = time.time()
    traj = solve(cfg, jax.random.PRNGKey(args.seed), args.timesteps,
                 densify_every=args.densify_every or None)
    solve_s = time.time() - t0

    # Render every timestep on a (possibly padded) grid (axis 0 = x, like FD).
    pad = args.pad_domain
    res = int(round(args.res * pad))
    wide = cfg.scale * pad
    xs = grid_samples(res, 2, wide)
    fields, losses, counts = [], [], []
    c = cfg.c
    for snap in traj:
        means, conics, values = concrete(cfg, snap["params"])
        u = eval_mixture(means, conics, values, xs, order=0,
                         mask=snap["active"]).u
        fields.append(np.asarray(u).reshape(res, res, c))
        losses.append(snap["loss"])
        counts.append(int(np.asarray(snap["active"]).sum()))
    fields = np.stack(fields)                       # (T, res, res, c)

    gt = np.asarray(solve_fd_2d(jnp.asarray(fields[0].squeeze(-1)
                                            if c == 1 else fields[0]),
                                wide, cfg.dt, args.timesteps - 1,
                                problem=args.problem, nu=cfg.nu))
    if c == 1:
        gt = gt[..., None]

    # Compare on the central [-scale, scale]^2 crop (all of it when pad=1).
    coords = np.linspace(-1.0, 1.0, res) * wide
    sel = np.abs(coords) <= cfg.scale + 1e-6
    rel = []
    for i in range(args.timesteps):
        a = fields[i][np.ix_(sel, sel)].reshape(-1)
        b = gt[i][np.ix_(sel, sel)].reshape(-1)
        denom = np.linalg.norm(b)
        rel.append(float(np.linalg.norm(a - b) / (denom if denom else 1.0)))

    np.save(os.path.join(out_dir, "fields.npy"), fields)
    np.save(os.path.join(out_dir, "fd_gt.npy"), gt)
    summary = {"problem": args.problem, "timesteps": args.timesteps,
               "dt": args.dt, "solve_s": solve_s,
               "args": {k: v for k, v in vars(args).items() if k != "out"},
               "per_step_rel_l2": rel, "max_rel_l2": max(rel),
               "mean_rel_l2": float(np.mean(rel)),
               "per_step_loss": losses, "active_counts": counts}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("per-step rel-L2 vs FD:", " ".join(f"{v:.4f}" for v in rel))
    print(f"max {max(rel):.4f}  mean {np.mean(rel):.4f}  "
          f"solve {solve_s:.0f}s  gaussians {counts[0]}->{counts[-1]}")
    return summary


if __name__ == "__main__":
    main()
