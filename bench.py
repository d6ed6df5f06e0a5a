"""Fused mixture kernels vs the blockwise XLA path on an NVIDIA GPU.

    python bench.py                # forward+backward at shapes (a)-(d), then
                                   # one 30-step epoch of the Burgers and NS
                                   # recipes
    python bench.py --part epochs  # one part only: kernels, epochs, sweep
                                   # (launch settings), trace (profile one
                                   # epoch per recipe into chiprun_out/) or
                                   # rollout (the flagship's rollout score
                                   # per product precision, with its spread)

Every time is forward+backward with ``diff_samples=False`` (collocation points
are constants in every training loop), the median of several windows that end
in ``block_until_ready``.  The card's name and power limit are printed before
the results; the last line is one JSON object naming the device.  Exits
non-zero when JAX finds no GPU or a measurement fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# The kernel shapes the bring-up measures: (a) the historical headline,
# (b) the Burgers training shape, (c) the NS shape, (d) d=1.
SHAPES = {
    "a": dict(m=65536, n=2048, d=2, c=1, order=2, period=None),
    "b": dict(m=4096, n=1664, d=2, c=1, order=2, period=None),
    "c": dict(m=2048, n=640, d=2, c=2, order=3, period=2.0),
    "d": dict(m=4096, n=256, d=1, c=1, order=2, period=None),
}


def make_inputs(m, n, d, c, seed=0, dtype=jnp.float32, **_):
    """Random mixture at a shape: means and samples in [-1, 1]^d, narrow
    anisotropic Gaussians (sigma ~ 0.02), normal values."""
    from pigs_tpu import gaussians
    ks = jax.random.split(jax.random.PRNGKey(seed), 5)
    means = jax.random.uniform(ks[0], (n, d), dtype) * 2.0 - 1.0
    scaling = jnp.exp(jax.random.normal(ks[1], (n, d), dtype) * 0.3 - 4.0)
    if d == 2:
        transforms = jax.random.normal(ks[2], (n, 1), dtype) * 0.5
        _, conics = gaussians.build_full_covariances(scaling, transforms)
    else:
        conics = (1.0 / scaling ** 2)[:, :, None]
    values = jax.random.normal(ks[3], (n, c), dtype)
    samples = jax.random.uniform(ks[4], (m, d), dtype) * 2.0 - 1.0
    return means, conics, values, samples


def cotangents(shape, seed=1, dtype=jnp.float32):
    """Fixed random cotangents, one per output field up to the order."""
    m, d, c, order = shape["m"], shape["d"], shape["c"], shape["order"]
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return tuple(jax.random.normal(ks[k], (m,) + (d,) * k + (c,), dtype)
                 for k in range(order + 1))


def loss_fn(shape, impl, samples, cots, sample_chunk=1024):
    """The linear functional sum_k <cot_k, field_k> of the mixture fields:
    its gradient is the mixture's vjp with fixed cotangents."""
    from pigs_tpu.ops.mixture import eval_mixture

    def loss(means, conics, values):
        out = eval_mixture(means, conics, values, samples,
                           order=shape["order"], period=shape["period"],
                           impl=impl, diff_samples=False,
                           sample_chunk=sample_chunk)
        return sum(jnp.sum(f * w) for f, w in zip(out, cots))

    return loss


def fwd_bwd(shape, impl):
    """(jitted value-and-grad, its arguments) at a shape."""
    means, conics, values, samples = make_inputs(**shape)
    loss = loss_fn(shape, impl, samples, cotangents(shape))
    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))
    return step, (means, conics, values)


def _sym(g):
    """Symmetrised conic gradient: the fused path returns the symmetric one,
    the dense path treats C[0,1] and C[1,0] as independent."""
    return 0.5 * (g + np.swapaxes(g, -1, -2))


def accuracy(name, impl="auto", chunk=4096):
    """Max abs error of the float32 path ``impl`` against the float64 dense
    oracle at a shape, each over the reference's max abs value, with its
    tolerance: 1e-5 for u, 1e-4 for derivatives and gradients (conic
    gradients symmetrised).  Returns {quantity: (error, tolerance)}."""
    from pigs_tpu.ops.mixture import eval_mixture
    from pigs_tpu.ops.oracle import eval_mixture_dense
    shape = SHAPES[name]
    order, period = shape["order"], shape["period"]
    means, conics, values, samples = make_inputs(**shape)
    cots = cotangents(shape)
    fields = jax.jit(lambda mu, co, v: eval_mixture(
        mu, co, v, samples, order=order, period=period, impl=impl,
        diff_samples=False))(means, conics, values)
    grads = jax.jit(jax.grad(loss_fn(shape, impl, samples, cots),
                             argnums=(0, 1, 2)))(means, conics, values)
    fields = [np.asarray(f, np.float64) for f in fields[:order + 1]]
    grads = [np.asarray(g, np.float64) for g in grads]

    with jax.enable_x64(True):
        f64 = lambda x: jnp.asarray(np.asarray(x), jnp.float64)
        mu, co, v = f64(means), f64(conics), f64(values)

        @jax.jit
        def ref_chunk(s, *w):
            def loss(mu, co, v):
                out = eval_mixture_dense(mu, co, v, s, order=order,
                                         period=period)
                return sum(jnp.sum(f * c) for f, c in zip(out, w)), out
            (_, out), g = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(mu, co, v)
            return out[:order + 1], g

        ref_fields, ref_grads = [], None
        for lo in range(0, shape["m"], chunk):
            out, g = ref_chunk(f64(samples[lo:lo + chunk]),
                               *(f64(w[lo:lo + chunk]) for w in cots))
            ref_fields.append([np.asarray(f) for f in out])
            g = [np.asarray(x) for x in g]
            ref_grads = g if ref_grads is None else [
                a + b for a, b in zip(ref_grads, g)]
    ref_fields = [np.concatenate(parts) for parts in zip(*ref_fields)]

    res = {}
    names = ("u", "ux", "uxx", "uxxx")
    for k, (a, b) in enumerate(zip(fields, ref_fields)):
        res[names[k]] = (float(np.abs(a - b).max() / np.abs(b).max()),
                         1e-5 if k == 0 else 1e-4)
    for nm, a, b in zip(("grad_means", "grad_conics", "grad_values"), grads,
                        ref_grads):
        if nm == "grad_conics":
            a, b = _sym(a), _sym(b)
        res[nm] = (float(np.abs(a - b).max() / np.abs(b).max()), 1e-4)
    return res


def median_time(fn, args, iters=10, windows=5):
    """Median seconds per call over ``windows`` windows of ``iters`` calls."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) / iters)
    return float(np.median(times))


def kernel_vs_xla(names=tuple(SHAPES)):
    """Forward+backward ms of the fused kernels and the blockwise XLA path."""
    res = {}
    for name in names:
        row = {}
        for impl in ("pallas", "xla"):
            step, args = fwd_bwd(SHAPES[name], impl)
            row[impl] = median_time(step, args) * 1e3
        print(f"shape ({name}) {SHAPES[name]}: kernel {row['pallas']:.4f} ms"
              f"  xla {row['xla']:.4f} ms", flush=True)
        res[name] = row
    return res


@contextlib.contextmanager
def mixture_path(impl):
    """Inside, every ``eval_mixture(impl="auto")`` takes the fused kernels
    (``"pallas"``) or the blockwise XLA path (``"xla"``).  JAX's caches are
    cleared on entry and exit, so no program traced for the other path is
    reused."""
    from pigs_tpu.ops import mixture
    rule = mixture.use_fused_kernel
    mixture.use_fused_kernel = lambda *a: impl == "pallas"
    jax.clear_caches()
    try:
        yield
    finally:
        mixture.use_fused_kernel = rule
        jax.clear_caches()


def recipe(name, train_timesteps=30):
    """(cfg, tcfg, ns_data) of the Burgers flagship or the NS recipe."""
    from pigs_tpu.models.model import ModelConfig
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train.pn import NSDataset, TrainConfig
    root = os.path.dirname(os.path.abspath(__file__))
    common = dict(dt=0.1, lr=3e-4, lr_min=2e-5, loss_weight_floor=0.05,
                  train_timesteps=train_timesteps, ema_decay=0.999)
    if name == "burgers":
        cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                                 nx=20, ny=20, d=2, scale=1.0)
        tcfg = TrainConfig(n_samples=4096, clip_norm=1.0,
                           skip_nonfinite_updates=True, **common)
        return cfg, tcfg, None
    cfg = ModelConfig.create(Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID,
                             nx=20, ny=20, d=2, scale=1.0, capacity=640,
                             split_criteria="vorticity")
    tcfg = TrainConfig(n_samples=2048, split_epoch=10000, **common)
    data = NSDataset.load(os.path.join(root, "artifacts", "ns_data_8traj.npz"))
    return cfg, tcfg, NSDataset(*(x[:-1] for x in data))


def epoch_runner(name):
    """A function running one warm 30-step ``pn_epoch_scan`` of a recipe (all
    steps active, split off) from a fixed initial state, returning its
    per-step losses; the inputs ``train_epoch`` prepares on the host are
    made once, outside it."""
    from pigs_tpu.models.model import randomize_state, sample_fields
    from pigs_tpu.train.pn import init_training, pn_epoch_scan
    from pigs_tpu.utils.sampling import (boundary_band_samples,
                                         collocation_samples)
    cfg, tcfg, ns_data = recipe(name)
    network, params, opt, opt_state = init_training(cfg, tcfg)
    k_rand, k_s, k_t, k_bc = jax.random.split(jax.random.PRNGKey(0), 4)
    n = tcfg.n_samples
    samples = collocation_samples(k_s, n, cfg.d, cfg.scale, cfg.dtype)
    time_samples = jax.random.uniform(k_t, (n,), cfg.dtype)
    bc = boundary_band_samples(k_bc, n, cfg.scale, cfg.dtype)
    recon = None
    if ns_data is not None:
        state = ns_data.state_for(cfg, 0)
        recon = jnp.stack([ns_data.recon_target(0, i + 1, samples)
                           for i in range(tcfg.train_timesteps)])
    else:
        state = randomize_state(cfg, k_rand, n=cfg.nx)
    prev = sample_fields(cfg, state, samples, bc)
    carry = [params, opt_state]

    def run():
        out = pn_epoch_scan(
            cfg, network, opt, carry[0], carry[1], state, prev, samples,
            time_samples, bc, jnp.asarray(tcfg.lr, cfg.dtype), tcfg.epsilon,
            tcfg.dt, tcfg.train_timesteps, recon_targets=recon,
            active_steps=jnp.asarray(tcfg.train_timesteps, jnp.int32),
            loss_weight_floor=jnp.asarray(tcfg.loss_weight_floor, cfg.dtype),
            skip_nonfinite=tcfg.skip_nonfinite_updates)
        carry[:] = out[:2]
        return jax.block_until_ready(out[4])

    return run


def epoch_time(name, impl, reps=5):
    """Median seconds of one 30-step ``pn_epoch_scan`` dispatch with every
    mixture evaluation on ``impl``."""
    with mixture_path(impl):
        run = epoch_runner(name)
        per_step = run()
        if not np.isfinite(np.asarray(per_step)).all():
            raise FloatingPointError(f"non-finite epoch losses {per_step}")
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
    return float(np.median(times))


def epochs():
    res = {}
    for name in ("burgers", "ns"):
        row = {impl: epoch_time(name, impl) * 1e3 for impl in ("pallas", "xla")}
        print(f"epoch ({name}, 30 steps): kernel {row['pallas']:.2f} ms"
              f"  xla {row['xla']:.2f} ms", flush=True)
        res[name] = row
    return res


def _union(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def trace_epoch(name, out_dir):
    """Profile one warm 30-step epoch; print per device its busy share of
    the window, and per plane the events that move data between host and
    device (their count says whether the scan's ``lax.cond`` costs a host
    round trip per step).  The full per-line table goes to
    ``<out_dir>/trace_summary.txt``."""
    import collections
    import glob
    from jax.profiler import ProfileData
    run = epoch_runner(name)
    run()
    with jax.profiler.trace(out_dir):
        t0 = time.perf_counter_ns()
        run()
        window = time.perf_counter_ns() - t0
    path = sorted(glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    lines_out = []
    for plane in ProfileData.from_file(path).planes:
        spans, moves = [], collections.Counter()
        for line in plane.lines:
            stats = collections.defaultdict(lambda: [0, 0.0])
            for ev in line.events:
                stats[ev.name][0] += 1
                stats[ev.name][1] += ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                low = ev.name.lower()
                if "memcpy" in low or "dtoh" in low or "htod" in low:
                    moves[ev.name] += 1
            top = sorted(stats.items(), key=lambda kv: -kv[1][1])[:12]
            lines_out.append(f"{plane.name} | {line.name}: " + "; ".join(
                f"{n[:60]} x{c} {d / 1e6:.3f}ms" for n, (c, d) in top))
        if plane.name.startswith("/device:"):
            busy = _union([s for s in spans if s[1] > s[0]])
            print(f"trace ({name}) {plane.name}: busy {busy / 1e6:.3f} ms "
                  f"of a {window / 1e6:.3f} ms window; copies "
                  f"{dict(moves)}", flush=True)
        elif moves:
            print(f"trace ({name}) {plane.name}: copies {dict(moves)}",
                  flush=True)
    with open(os.path.join(out_dir, "trace_summary.txt"), "w") as f:
        f.write("\n".join(lines_out) + "\n")


def _perturbed(params, seed, rel):
    """Every weight scaled by ``1 + rel * N(0, 1)``."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(jax.random.PRNGKey(seed), len(leaves))
    return jax.tree_util.tree_unflatten(tree, [
        x * (1.0 + rel * jax.random.normal(k, x.shape, x.dtype))
        for k, x in zip(keys, leaves)])


def rollout_precision(perturbations=4, rel=1e-6, early=12):
    """The committed flagship checkpoint's 50-step rollout, scored against
    the FD reference as ``scripts/validate_pn.py`` scores it, with the
    network's products at one bfloat16 pass and in exact float32: each once
    as committed and once per seed with its weights perturbed by ``rel``.
    The spread over seeds is how much of a score is the rollout amplifying
    last-bit differences; steps 1..``early`` come before that sets in and
    are compared with the committed per-step errors."""
    import dataclasses
    from pigs_tpu.models.model import make_network
    from pigs_tpu.train.checkpoint import load_checkpoint_file
    from pigs_tpu.train.pn import (TrainConfig, init_training, rollout,
                                   rollout_metrics)
    from pigs_tpu.utils.fd import solve_fd_2d
    root = os.path.dirname(os.path.abspath(__file__))
    cfg, tcfg, _ = recipe("burgers")
    _, like, _, _ = init_training(cfg, TrainConfig())
    ema = load_checkpoint_file(os.path.join(
        root, "artifacts", "burgers_ns4096_ema2_ckpt_30000.npz"),
        like).ema_params
    with open(os.path.join(root, "results_burgers_ns4096_ema2",
                           "summary.json")) as f:
        committed = np.asarray(json.load(f)["per_step_rel_norm"])
    print("rollout committed steps 1-%d: %s" % (early, " ".join(
        f"{v:.4f}" for v in committed[1:early + 1])), flush=True)
    gt, res = None, {}
    for bf16 in (True, False):
        network = dataclasses.replace(make_network(cfg), bf16_products=bf16)
        runs = []
        for seed in range(perturbations + 1):
            params = ema if seed == 0 else _perturbed(ema, seed, rel)
            frames, _ = rollout(cfg, network, params, n_steps=50, res=64,
                                dt=tcfg.dt)
            if gt is None:
                u0 = jnp.asarray(np.flipud(frames[0, 0]).T)
                gt = np.stack([np.flipud(g.T) for g in np.asarray(
                    solve_fd_2d(u0, cfg.scale, tcfg.dt, 50, problem="burgers",
                                nu=cfg.coeff.nu))])
            m = rollout_metrics(frames[:, 0], gt)
            steps = np.asarray(m["per_step_rel_norm"][1:early + 1])
            runs.append({"seed": seed, "mean_rel_norm": m["mean_rel_norm"],
                         "early_max_gap": float(np.abs(
                             steps - committed[1:early + 1]).max())})
            print(f"rollout bf16_products={bf16} seed={seed}: mean rel-L2 "
                  f"{m['mean_rel_norm']:.4f}; steps 1-{early}: " + " ".join(
                      f"{v:.4f}" for v in steps), flush=True)
        means = [r["mean_rel_norm"] for r in runs]
        print(f"rollout bf16_products={bf16}: mean rel-L2 over "
              f"{len(means)} runs {np.mean(means):.4f}, min {min(means):.4f}"
              f", max {max(means):.4f}", flush=True)
        res["bf16" if bf16 else "float32"] = runs
    return res


SWEEP_FWD = [(64, 32, 4), (128, 32, 4), (64, 64, 4), (128, 64, 8),
             (32, 32, 2), (64, 16, 2), (32, 64, 4)]
SWEEP_BWD = [(64, 32, 4), (128, 32, 4), (64, 16, 4), (32, 32, 2),
             (128, 16, 4), (64, 64, 8)]


def sweep(names=("a", "b", "c")):
    """Forward and parameter-grad kernels alone, per launch setting."""
    from pigs_tpu.ops import pallas_mixture as pm
    res = {}
    for name in names:
        shape = SHAPES[name]
        means, conics, values, samples = make_inputs(**shape)
        packed = pm._pack_conics(conics)
        cots = tuple(jnp.ones((shape["m"], g * shape["c"]), jnp.float32)
                     for g in pm.GROUP_SIZES[:shape["order"] + 1])
        for bm, bn, w in SWEEP_FWD:
            f = jax.jit(lambda *a, bm=bm, bn=bn, w=w: pm._pallas_forward(
                *a, order=shape["order"], period=shape["period"],
                block_m=bm, block_n=bn, num_warps=w))
            t = median_time(f, (means, packed, values, samples)) * 1e3
            res[f"{name} fwd bm={bm} bn={bn} warps={w}"] = t
            print(f"sweep ({name}) fwd block_m={bm} block_n={bn} warps={w}: "
                  f"{t:.4f} ms", flush=True)
        for bn, bm, w in SWEEP_BWD:
            f = jax.jit(lambda *a, bm=bm, bn=bn, w=w: pm._pallas_backward(
                *a, order=shape["order"], period=shape["period"],
                diff_samples=False, block_n=bn, block_m=bm, num_warps=w))
            t = median_time(f, (means, packed, values, samples, cots)) * 1e3
            res[f"{name} bwd bn={bn} bm={bm} warps={w}"] = t
            print(f"sweep ({name}) bwd block_n={bn} block_m={bm} warps={w}: "
                  f"{t:.4f} ms", flush=True)
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--part", action="append",
                   choices=("kernels", "epochs", "sweep", "trace",
                            "rollout"),
                   help="run only this part (repeatable); default: kernels "
                        "and epochs")
    args = p.parse_args()

    from pigs_tpu.utils.runtime import card_line, enable_compile_cache
    from pigs_tpu.utils.runtime import require_gpu
    enable_compile_cache()
    dev = require_gpu()
    print(f"card: {card_line()}", flush=True)
    out = {}
    parts = args.part or ["kernels", "epochs"]
    if "kernels" in parts:
        out["fwd_bwd_ms"] = kernel_vs_xla()
    if "epochs" in parts:
        out["epoch_ms"] = epochs()
    if "sweep" in parts:
        out["sweep_ms"] = sweep()
    if "rollout" in parts:
        out["rollout"] = rollout_precision()
    if "trace" in parts:
        root = os.path.dirname(os.path.abspath(__file__))
        for name in ("burgers", "ns"):
            trace_epoch(name, os.path.join(root, "chiprun_out",
                                           f"trace_{name}"))
    out["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                     "count": len(jax.devices())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
