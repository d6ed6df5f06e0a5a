#!/usr/bin/env python
"""Sharded-evaluation scaling harness: samples/s vs device count.

Run it on a machine with several GPUs to measure scaling across cards, or
locally with
``JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8``
for a functional (not performance-representative) check.

Measures weak scaling of the Gaussian-axis-sharded mixture evaluation
(psum over the model axis) and of the data-parallel evaluation (samples
sharded), per device count 1..N.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--samples-per-device", type=int, default=8192)
    p.add_argument("--gaussians", type=int, default=2048)
    p.add_argument("--order", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from pigs_tpu import gaussians
    from pigs_tpu.parallel.sharded import eval_mixture_sharded

    devices = jax.devices()
    print(f"devices: {len(devices)} x {devices[0].device_kind}")

    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 5)
    n = args.gaussians
    means = (jax.random.uniform(ks[0], (n, 2)) * 2 - 1).astype(jnp.float32)
    scaling = jnp.exp(jax.random.normal(ks[1], (n, 2)) * 0.3 - 4.0)
    _, conics = gaussians.build_full_covariances(
        scaling.astype(jnp.float32), jnp.zeros((n, 1), jnp.float32))
    values = jax.random.normal(ks[2], (n, 1), jnp.float32)

    results = {}
    counts = [c for c in (1, 2, 4, 8, len(devices)) if c <= len(devices)]
    for ndev in sorted(set(counts)):
        mesh = Mesh(np.asarray(devices[:ndev]).reshape(ndev, 1),
                    ("data", "model"))
        m = args.samples_per_device * ndev
        samples = jax.device_put(
            (jax.random.uniform(ks[3], (m, 2)) * 2 - 1).astype(jnp.float32),
            NamedSharding(mesh, P("data")))

        def run():
            return eval_mixture_sharded(mesh, means, conics, values, samples,
                                        order=args.order)

        out = run()
        jax.block_until_ready(out.u)
        t = time.time()
        for _ in range(args.iters):
            out = run()
        jax.block_until_ready(out.u)
        dt = (time.time() - t) / args.iters
        rate = m / dt
        results[ndev] = rate
        eff = rate / (results[1] * ndev) if 1 in results else float("nan")
        print(f"devices={ndev}: {m} samples in {dt*1e3:.2f} ms "
              f"-> {rate/1e6:.2f} Msamples/s (weak-scaling eff {eff:.2f})")


if __name__ == "__main__":
    main()
