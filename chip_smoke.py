#!/usr/bin/env python
"""Bring-up smoke run: the main path at full width on NVIDIA GPUs, in one process.

    python chip_smoke.py              # phases 1-6 on one GPU
    python chip_smoke.py --four-chip  # the sharded path on four GPUs, only

Phases (one GPU):
  1. device   — JAX must find a GPU (no CPU fallback); prints the card's name
                and power limit.
  2. kernel   — the mixture path ``impl="auto"`` picks, compiled at shapes
                (a)-(d) of bench.py, against the float64 dense oracle (values
                and gradients); prints ``memory_analysis()`` per shape.
  3. burgers  — the flagship recipe (capacity 1664, 4096 samples, 50-step
                curriculum, EMA, clipping) for a few epochs through ``train()``
                with a checkpoint saved and resumed; then the 50-step rollout of
                the committed checkpoint through ``scripts/validate_pn.py``,
                scored against the FD reference.
  4. ns       — the NS recipe (capacity 640, order 3, periodic, vorticity
                criteria) for a few epochs with adaptive splitting inside the
                scan, on the committed 8-trajectory dataset.
  5. no_mlp   — a 2D Burgers solve through ``scripts/validate_no_mlp_2d.py``.
  6. gpu tests— the tests marked ``gpu``, in this process.

With ``--four-chip``: ``eval_mixture_sharded`` and ``eval_mixture_ring`` on
(4, 1) and (2, 2) meshes at shape (a) against single-device ``eval_mixture``,
and the data-parallel training step at the Burgers recipe size against
``pn_step``.

Any failed phase makes the script exit non-zero without the result line.  The
last line on success is ``{"ok": true, "device": {...}}``.  Outputs go to
``chiprun_out/smoke``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "smoke")
# The flagship's committed rollout score (results_burgers_ns4096_ema2).
FLAGSHIP_MEAN_REL_L2 = 0.2016
FLAGSHIP_TOLERANCE = 0.01


def check(ok, message):
    """Fail the phase (unlike ``assert``, also under ``python -O``)."""
    if not ok:
        raise RuntimeError(message)


def phase_kernel():
    import jax
    import jax.numpy as jnp
    import bench
    from pigs_tpu.ops.mixture import use_fused_kernel
    for name, shape in bench.SHAPES.items():
        check(use_fused_kernel(jax.default_backend(), shape["d"],
                               jnp.float32), "auto does not pick the kernel")
        acc = bench.accuracy(name, impl="auto")
        print(f"  shape ({name}) {shape}: " + " ".join(
            f"{k}={e:.2e}/{tol:.0e}" for k, (e, tol) in acc.items()))
        bad = {k: v for k, v in acc.items() if not v[0] <= v[1]}
        check(not bad, f"shape ({name}) outside tolerance: {bad}")
        step, args = bench.fwd_bwd(shape, "auto")
        print(f"  memory ({name}): "
              f"{step.lower(*args).compile().memory_analysis()}")


def flagship_rollout():
    """The committed flagship checkpoint rolled out for 50 steps and scored
    against the FD reference by ``scripts/validate_pn.py`` with the recipe's
    flags (restoring at ``--epochs`` skips training).  Returns the script's
    summary."""
    from scripts import validate_pn
    out = os.path.join(OUT, "burgers_rollout")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "checkpoints"))
    shutil.copy(os.path.join(ROOT, "artifacts",
                             "burgers_ns4096_ema2_ckpt_30000.npz"),
                os.path.join(out, "checkpoints", "ckpt_30000.npz"))
    flags = ["--problem", "burgers", "--epochs", "30000", "--dt", "0.1",
             "--loss-weight-floor", "0.05", "--lr", "3e-4", "--lr-min", "2e-5",
             "--train-timesteps", "50", "--n-samples", "4096",
             "--ema-decay", "0.999", "--clip-norm", "1.0", "--skip-nonfinite",
             "--epochs-per-dispatch", "50", "--resume", "--out", out]
    return validate_pn.main(flags)


def phase_burgers():
    import jax
    import numpy as np
    import bench
    from pigs_tpu.train.checkpoint import latest_step
    from pigs_tpu.train.pn import train

    cfg, tcfg, _ = bench.recipe("burgers", train_timesteps=50)
    tcfg = tcfg._replace(n_epochs=4, epochs_per_dispatch=2, save_step=2,
                         log_step=1)
    ckpt = os.path.join(OUT, "burgers_train", "checkpoints")
    shutil.rmtree(os.path.dirname(ckpt), ignore_errors=True)
    t0 = time.perf_counter()
    first = train(cfg, tcfg, checkpoint_dir=ckpt,
                  log_fn=lambda m: print("  " + m))
    logs = []
    resumed = train(cfg, tcfg._replace(n_epochs=6), checkpoint_dir=ckpt,
                    resume=True, log_fn=logs.append)
    print("\n".join("  " + m for m in logs))
    print(f"  train + resume: {time.perf_counter() - t0:.1f} s wall "
          "(compilation included)")
    check(any("Resumed" in m for m in logs), "did not resume")
    check(latest_step(ckpt) == 6, f"latest step {latest_step(ckpt)}, not 6")
    check(len(resumed.training_loss) == 6, "loss history not restored")
    losses = first.training_loss + resumed.training_loss
    check(np.isfinite(losses).all(), f"non-finite losses {losses}")
    check(all(np.isfinite(np.asarray(leaf)).all()
              for leaf in jax.tree_util.tree_leaves(resumed.ema_params)),
          "non-finite EMA parameters")

    summary = flagship_rollout()
    mean = summary["mean_rel_norm"]
    check(np.isfinite(summary["per_step_rel_norm"]).all(),
          "non-finite rollout error")
    print(f"  rollout: mean rel-L2 {mean:.4f} (committed "
          f"{FLAGSHIP_MEAN_REL_L2}), {summary['evo_time_s'] * 1e3:.1f} ms "
          "for 50 steps")
    gap = abs(mean - FLAGSHIP_MEAN_REL_L2)
    check(gap <= FLAGSHIP_TOLERANCE,
          f"rollout mean rel-L2 {mean:.4f} is {gap:.4f} from the committed "
          f"{FLAGSHIP_MEAN_REL_L2}")


def phase_ns():
    import numpy as np
    import bench
    from pigs_tpu.train.pn import train
    cfg, tcfg, data = bench.recipe("ns")
    # Split from epoch 1 on: adaptive prune/split runs inside the scan.
    tcfg = tcfg._replace(n_epochs=4, epochs_per_dispatch=2, split_epoch=0,
                         clip_norm=1.0, skip_nonfinite_updates=True,
                         log_step=1)
    t0 = time.perf_counter()
    result = train(cfg, tcfg, ns_data=data, log_fn=lambda m: print("  " + m))
    print(f"  train: {time.perf_counter() - t0:.1f} s wall "
          "(compilation included)")
    check(len(result.training_loss) == 4, "missing epochs")
    check(np.isfinite(result.training_loss).all(),
          f"non-finite losses {result.training_loss}")


def phase_no_mlp():
    import numpy as np
    from scripts import validate_no_mlp_2d
    out = os.path.join(OUT, "no_mlp_2d_burgers")
    summary = validate_no_mlp_2d.main(
        ["--problem", "burgers", "--timesteps", "3", "--out", out])
    check(np.isfinite(summary["per_step_loss"]).all()
          and np.isfinite(summary["per_step_rel_l2"]).all(),
          f"non-finite no-MLP solve: {summary}")


def phase_gpu_tests():
    import pytest
    os.environ["PIGS_TESTS_ON_GPU"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    check(rc == 0, f"gpu tests failed (pytest exit code {rc})")


def _close(name, got, ref, rel):
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    print(f"  {name}: max err / max |ref| = {err:.2e} (limit {rel:.0e})")
    check(err <= rel, f"{name} outside tolerance")


def phase_four_chip():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    import bench
    from pigs_tpu.models.model import make_initial_state, sample_fields
    from pigs_tpu.ops.mixture import eval_mixture
    from pigs_tpu.parallel.mesh import make_mesh
    from pigs_tpu.parallel.sharded import (eval_mixture_ring,
                                           eval_mixture_sharded)
    from pigs_tpu.parallel.train import make_dp_train_step
    from pigs_tpu.train.pn import init_training, pn_step

    check(len(jax.devices()) == 4, f"{len(jax.devices())} devices, need 4")
    shape = bench.SHAPES["a"]
    means, conics, values, samples = bench.make_inputs(**shape)
    ref = jax.jit(lambda *a: eval_mixture(*a, samples, order=2,
                                          diff_samples=False))(
        means, conics, values)
    for mesh_shape in ((4, 1), (2, 2)):
        mesh = make_mesh(shape=mesh_shape)
        for name, fn in (("sharded", eval_mixture_sharded),
                         ("ring", eval_mixture_ring)):
            out = jax.jit(lambda *a: fn(mesh, *a, order=2))(
                means, conics, values, samples)
            for k, (tol, a, b) in enumerate(zip((1e-5, 1e-4, 1e-4), out,
                                                ref)):
                _close(f"{name} {mesh_shape} order {k}", a, b, tol)

    # Data-parallel step at the Burgers recipe size against pn_step, both at
    # the program's precision.  The network runs on the replicated state in
    # both, so the losses differ only in the order of float32 sums.  SGD: the
    # update is linear in the gradients, which differ in where the backward's
    # bfloat16 roundings fall (per shard against once).
    cfg, tcfg, _ = bench.recipe("burgers")
    network, params, _, _ = init_training(cfg, tcfg)
    opt = optax.inject_hyperparams(optax.sgd)(learning_rate=1e-3)
    opt_state = opt.init(params)
    state = make_initial_state(cfg)
    key = jax.random.PRNGKey(0)
    m = tcfg.n_samples
    f32 = jnp.float32
    pts = jax.random.uniform(key, (m, 2), f32) * 2 - 1
    ts = jax.random.uniform(key, (m,), f32)
    bc = jax.random.uniform(jax.random.PRNGKey(1), (m, 2), f32) * 2 - 1
    prev = sample_fields(cfg, state, pts, bc)
    lr, t = jnp.asarray(1e-3, f32), jnp.zeros((), f32)
    dp_step = make_dp_train_step(make_mesh(shape=(4, 1)), cfg, network, opt)
    p_dp, _, _, _, loss_dp = dp_step(params, opt_state, state, prev, pts, ts,
                                     bc, lr, t, tcfg.dt)
    p_sd, _, _, _, losses_sd, _, _ = pn_step(
        cfg, network, opt, params, opt_state, state, prev, pts, ts, bc,
        jnp.ones((), f32), lr, 1.0, t, tcfg.dt)
    print(f"  dp loss {float(loss_dp):.8f}  single-device loss "
          f"{float(losses_sd.total):.8f}")
    np.testing.assert_allclose(float(loss_dp), float(losses_sd.total),
                               rtol=2e-4)
    for a, b in zip(jax.tree_util.tree_leaves(p_dp),
                    jax.tree_util.tree_leaves(p_sd)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=2e-5)
    print("  dp params match single-device pn_step")


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--four-chip", action="store_true",
                   help="run only the four-GPU sharded path")
    args = p.parse_args()

    sys.path.insert(0, ROOT)
    import jax
    from pigs_tpu.utils.runtime import (card_line, enable_compile_cache,
                                        require_gpu)
    enable_compile_cache()
    dev = require_gpu()                                     # phase 1
    print(f"card: {card_line()}", flush=True)
    print(f"jax {jax.__version__}: {len(jax.devices())} x {dev.device_kind}",
          flush=True)
    os.makedirs(OUT, exist_ok=True)

    phases = ([("four_chip", phase_four_chip)] if args.four_chip else
              [("kernel", phase_kernel), ("burgers", phase_burgers),
               ("ns", phase_ns), ("no_mlp", phase_no_mlp),
               ("gpu_tests", phase_gpu_tests)])
    failed = []
    for name, fn in phases:
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                      # report, run the rest, fail
            traceback.print_exc()
            failed.append(name)
        print(f"== phase {name}: {'FAILED' if name in failed else 'ok'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
