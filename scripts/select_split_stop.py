#!/usr/bin/env python
"""Honest stop-step selection for eval-time densification.

Round-2's 0.175 headline picked the rollout-densification stop step by its
score on the same single FD trajectory it was reported on (oracle
selection).  This script separates selection from evaluation:

  1. SELECTION: roll the trained flagship out from K held-out randomized ICs
     (``randomize_state`` — the same distribution training draws from,
     model_pn.py:439-502) for every candidate stop step, scoring each against
     an FD solve started from that IC's rendered t=0 field.
  2. EVALUATION: report, on the standard eval IC (``make_initial_state``,
     the reference's rollout initial state, main_pn.py:289):
       * parity        — reference eval semantics, no densification
                         (main_pn.py:448 split=False),
       * held-out      — densify with the stop step chosen in (1),
       * oracle        — the per-trajectory best stop step (upper bound).

Example:
  python scripts/select_split_stop.py --ckpt artifacts/burgers_dt01_ckpt_30000.npz \
      --out results_burgers_dt01_heldout
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt", default="artifacts/burgers_dt01_ckpt_30000.npz",
                   help="checkpoint file (train/checkpoint.py format)")
    p.add_argument("--problem", default="burgers")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--n-select", type=int, default=3,
                   help="held-out selection ICs")
    p.add_argument("--stops", default="0,8,14,20,26,32,38,44,50",
                   help="candidate stop steps (0 = no densification)")
    p.add_argument("--rollout-steps", type=int, default=50)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=100,
                   help="base seed for the held-out ICs (disjoint from the "
                        "training stream)")
    p.add_argument("--out", default="results_burgers_dt01_heldout")
    args = p.parse_args(argv)

    import jax
    from pigs_tpu.utils.runtime import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.models.model import (ModelConfig, make_initial_state,
                                       randomize_state)
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.checkpoint import load_checkpoint_file
    from pigs_tpu.train.pn import (TrainConfig, init_training, rollout,
                                   rollout_metrics)
    from pigs_tpu.utils.fd import solve_fd_2d

    problem = Problem[args.problem.upper()]
    cfg = ModelConfig.create(problem, IntegrationRule.TRAPEZOID,
                             nx=args.nx, ny=args.nx, d=2, scale=1.0)
    network, params, _, _ = init_training(cfg, TrainConfig(n_epochs=1))
    restored = load_checkpoint_file(args.ckpt, params)
    # Roll out with the same parameters the validation run evaluated: the EMA
    # shadow when the checkpoint carries one (validate_pn.py).
    if restored.ema_params is not None:
        print("using EMA params", flush=True)
        params = restored.ema_params
    else:
        params = restored.params
    print(f"restored {args.ckpt}", flush=True)

    stops = [int(s) for s in args.stops.split(",")]

    def score(state, stop):
        frames, _ = rollout(cfg, network, params,
                            n_steps=args.rollout_steps, res=args.res,
                            state=state, densify=stop if stop else False,
                            dt=args.dt)
        f0 = frames[0, 0]
        u0_fd = jnp.asarray(np.flipud(f0).T)
        gt = np.asarray(solve_fd_2d(u0_fd, cfg.scale, args.dt,
                                    args.rollout_steps,
                                    problem=args.problem, nu=cfg.coeff.nu))
        gt_frames = np.stack([np.flipud(g.T) for g in gt])
        return rollout_metrics(frames[:, 0], gt_frames)["mean_rel_norm"]

    t0 = time.time()
    # 1. selection on held-out ICs
    select = {}
    for stop in stops:
        vals = []
        for k in range(args.n_select):
            state = randomize_state(cfg, jax.random.PRNGKey(args.seed + k),
                                    n=args.nx)
            vals.append(score(state, stop))
        select[stop] = float(np.mean(vals))
        print(f"selection stop={stop}: mean rel-L2 {select[stop]:.4f} "
              f"(per-IC {['%.3f' % v for v in vals]})", flush=True)
    heldout_stop = min(select, key=select.get)

    # 2. evaluation on the standard eval trajectory
    eval_state = make_initial_state(cfg)
    eval_scores = {stop: score(eval_state, stop) for stop in stops}
    oracle_stop = min(eval_scores, key=eval_scores.get)
    summary = {
        "problem": args.problem, "ckpt": args.ckpt, "stops": stops,
        "selection_mean_rel_l2": {str(k): v for k, v in select.items()},
        "heldout_stop": heldout_stop,
        "eval_mean_rel_l2": {str(k): v for k, v in eval_scores.items()},
        "parity": eval_scores[0],
        "heldout": eval_scores[heldout_stop],
        "oracle_stop": oracle_stop,
        "oracle": eval_scores[oracle_stop],
        "wall_s": time.time() - t0,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in
                      ("parity", "heldout_stop", "heldout", "oracle_stop",
                       "oracle")}, indent=1), flush=True)


if __name__ == "__main__":
    main()
