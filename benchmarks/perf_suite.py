#!/usr/bin/env python
"""Performance suite: the layer numbers measured through the public API in
one run on an NVIDIA GPU.

  python benchmarks/perf_suite.py            # everything (needs a GPU)
  python benchmarks/perf_suite.py --skip-mixture

Covers:
  * mixture headline (bench.py shape (a), 65536x2048 order-2 fwd+bwd, fused
    kernels and blockwise XLA)
  * neighbor aggregation (L=16, K=16, F=6 -> E=25): dense vs factored,
    fwd and fwd+bwd, n in {512, 1664}
  * pn_step at capacity 928 and 1664 (forward + losses + grads + Adam)
  * pn_epoch_scan with a 30-step curriculum (one dispatch per epoch)
  * 50-step rollout at 64x64 (inference scan)

Prints one JSON dict at the end.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(f, *args, iters=10, reps=5, **kw):
    jax.block_until_ready(f(*args, **kw))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = f(*args, **kw)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def bench_aggregation(results, n):
    from pigs_tpu.ops.aggregate import (aggregate_neighbors,
                                        aggregate_neighbors_factored,
                                        neighbor_mask)
    L, K, F, d = 16, 16, 6, 2
    ks = jax.random.split(jax.random.PRNGKey(0), 8)
    feats = jax.random.normal(ks[0], (n, L), jnp.float32)
    transform = jax.random.normal(ks[1], (L, L), jnp.float32) / jnp.sqrt(L)
    queries = jax.random.normal(ks[2], (n, K), jnp.float32)
    keys = jax.random.normal(ks[3], (n, K), jnp.float32)
    freqs = jnp.abs(jax.random.normal(ks[4], (F,), jnp.float32)) * 10.0
    E = 1 + 2 * F * d
    dist_t = jax.random.normal(ks[5], (L, 2 * E), jnp.float32) / jnp.sqrt(E)
    means = (jax.random.uniform(ks[6], (n, d), jnp.float32) * 2.0 - 1.0)
    # Covariances sized like the trained models: ~0.1 std -> a few dozen
    # neighbors per Gaussian at n~1600 in [-1,1]^2.  Past that scale shrink
    # sigma ~ 1/sqrt(n) (splitting halves covariances, model_pn.py:253-264),
    # keeping the neighbor count — i.e. the mask sparsity — realistic.
    sig_val = 0.1 * min(1.0, (1664.0 / n) ** 0.5)
    sig = sig_val * jnp.ones((n,), jnp.float32)
    cov = jnp.einsum("n,ij->nij", sig ** 2, jnp.eye(d, dtype=jnp.float32))
    active = jnp.ones((n,), bool)
    mask = neighbor_mask(means, cov, active)
    out = {"mean_neighbors": float(jnp.mean(jnp.sum(mask, axis=1)))}

    def dense(f, q, k, m):
        return aggregate_neighbors(f, transform, q, k, freqs, dist_t, m, mask)

    def factored(f, q, k, m):
        return aggregate_neighbors_factored(f, transform, q, k, freqs, dist_t,
                                            m, mask)

    for name, fn in [("dense", dense), ("factored", factored)]:
        fwd = jax.jit(fn)
        loss = jax.jit(jax.grad(
            lambda f, q, k, m: jnp.sum(fn(f, q, k, m) ** 2),
            argnums=(0, 1, 2, 3)))
        out[f"{name}_fwd_ms"] = timed(fwd, feats, queries, keys, means) * 1e3
        out[f"{name}_fwdbwd_ms"] = timed(loss, feats, queries, keys,
                                         means) * 1e3
    results[f"aggregation_n{n}"] = out
    print(f"aggregation n={n}:", json.dumps(out), flush=True)


def bench_pn(results, nx, capacity):
    from pigs_tpu.models.model import ModelConfig, make_initial_state
    from pigs_tpu.pde import IntegrationRule, Problem
    from pigs_tpu.train import pn as tpn

    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=nx, ny=nx, d=2, scale=1.0, capacity=capacity)
    tcfg = tpn.TrainConfig(n_epochs=1, n_samples=1024)
    network, params, opt, opt_state = tpn.init_training(cfg, tcfg)
    key = jax.random.PRNGKey(0)
    state = make_initial_state(cfg)
    samples = tpn.collocation_samples(key, tcfg.n_samples, cfg.d, cfg.scale,
                                      cfg.dtype)
    time_samples = jax.random.uniform(key, (tcfg.n_samples,), cfg.dtype)
    bc = tpn.boundary_band_samples(key, tcfg.n_samples, cfg.scale, cfg.dtype)
    prev = tpn.sample_fields(cfg, state, samples, bc)
    lw = jnp.ones((), cfg.dtype)

    def step(params, opt_state, state, prev, lw):
        return tpn.pn_step(cfg, network, opt, params, opt_state, state, prev,
                           samples, time_samples, bc, lw,
                           jnp.asarray(tcfg.lr, cfg.dtype), tcfg.epsilon,
                           0.0, tcfg.dt)

    t = timed(step, params, opt_state, state, prev, lw, iters=20)
    results[f"pn_step_cap{cfg.capacity}_ms"] = t * 1e3
    print(f"pn_step capacity={cfg.capacity}: {t*1e3:.2f} ms", flush=True)

    def epoch(params, opt_state, state, prev, act):
        return tpn.pn_epoch_scan(
            cfg, network, opt, params, opt_state, state, prev,
            samples, time_samples, bc, jnp.asarray(tcfg.lr, cfg.dtype),
            tcfg.epsilon, tcfg.dt, 30,
            active_steps=act,
            loss_weight_floor=jnp.zeros((), cfg.dtype))

    t = timed(epoch, params, opt_state, state, prev,
              jnp.asarray(30, jnp.int32), iters=5)
    results[f"pn_epoch30_cap{cfg.capacity}_ms"] = t * 1e3
    print(f"pn_epoch_scan 30 steps capacity={cfg.capacity}: {t*1e3:.1f} ms",
          flush=True)
    # Curriculum skip cost: same 30-step compile at curriculum length 1 —
    # with the lax.cond whole-step skip this should cost ~1 step, not 30.
    t1 = timed(epoch, params, opt_state, state, prev,
               jnp.asarray(1, jnp.int32), iters=5)
    results[f"pn_epoch30_act1_cap{cfg.capacity}_ms"] = t1 * 1e3
    print(f"pn_epoch_scan 30 steps, 1 active, capacity={cfg.capacity}: "
          f"{t1*1e3:.1f} ms", flush=True)
    return cfg, network, params


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--skip-mixture", action="store_true")
    p.add_argument("--skip-agg", action="store_true")
    p.add_argument("--skip-pn", action="store_true")
    p.add_argument("--agg-ns", default="512,1664",
                   help="comma-separated aggregation sizes (post-split "
                        "scales: 4096,8192)")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    global jax, jnp
    import jax
    import jax.numpy as jnp
    from pigs_tpu.utils.runtime import (card_line, enable_compile_cache,
                                        require_gpu)
    enable_compile_cache()
    dev = require_gpu()
    results = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())},
               "card": card_line()}

    if not args.skip_agg:
        for n in (int(s) for s in args.agg_ns.split(",")):
            bench_aggregation(results, n)

    if not args.skip_pn:
        from pigs_tpu.train.pn import rollout
        cfg, network, params = bench_pn(results, 20, 928)
        bench_pn(results, 20, None)  # default capacity (1664)
        frames, evo = rollout(cfg, network, params, n_steps=50, res=64)
        results["rollout50_res64_s"] = evo
        print(f"rollout 50 steps: {evo*1e3:.1f} ms", flush=True)

    if not args.skip_mixture:
        from bench import kernel_vs_xla
        results["mixture_fwd_bwd_ms"] = kernel_vs_xla(("a",))["a"]

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
