"""PointNet-style dynamics network predicting per-timestep Gaussian deltas.

Plain-JAX design of the reference's model layer (model_pn.py:44-299): the same
architecture — a learned global canonical transform (``InputTransform`` built from a
PointNet ``LatentTransform`` encoder + per-quantity ``TransformNet`` heads), a
per-Gaussian input projection, multi-head attention-based neighbor aggregation, and
a delta head emitting (dmeans, dscaling, dtransforms, du) — expressed functionally
over padded per-Gaussian buffers with an active mask (masked mean-pool replaces the
variable-length mean over Gaussians at model_pn.py:114).

Parameters are a nested dict whose paths and shapes follow the layer names
(``params/InputTransform_0/latent_net/Dense_0/kernel``, ``params/delta_net/...``),
so checkpoints key by path.  Dense layers use lecun-normal kernels and zero
biases; the aggregation transforms start uniform in [0, 2) and are shifted to
[-1, 1) when applied.

Sizes (model_pn.py:44-49): LATENT=16, L1=16, L2=32, L3=48, EMBEDDING=25, heads=2.
Activation is Tanh (model_pn.py:425-426).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from pigs_tpu.ops.aggregate import aggregate_neighbors_factored
from pigs_tpu.ops.matmul import matmul

__all__ = ["DynamicsNetwork", "Deltas", "WaveAct", "RBFAct", "LATENT_SIZE",
           "ATTENTION_HEADS", "EMBEDDING_SIZE"]

LATENT_SIZE = 16
L1_SIZE = 16
L2_SIZE = 32
L3_SIZE = 48
EMBEDDING_SIZE = 25
ATTENTION_HEADS = 2

_lecun_normal = jax.nn.initializers.lecun_normal()

class Deltas(NamedTuple):
    dmeans: jax.Array       # (N, d)
    dscaling: jax.Array     # (N, d)
    dtransforms: jax.Array  # (N, T)
    du: jax.Array           # (N, c)
    # Per-head magnitude of the aggregated features, for the attention-magnitude
    # loss (model_pn.py:892-901).
    head_magnitudes: jax.Array  # (heads,)


class WaveAct:
    """Learned sin+cos activation (model_pn.py:26-33; unused by the default
    Model, which hardcodes Tanh at model_pn.py:425-426, but part of the API)."""

    def init(self, key, x=None):
        del key, x
        return {"params": {"w1": jnp.ones((1,)), "w2": jnp.ones((1,))}}

    def apply(self, params, x):
        p = params["params"]
        return p["w1"] * jnp.sin(x) + p["w2"] * jnp.cos(x)


@dataclasses.dataclass(frozen=True)
class RBFAct:
    """Gaussian radial activation (model_pn.py:35-42)."""

    in_dim: int

    def init(self, key, x=None):
        del key, x
        return {"params": {"b": jnp.ones((1,)),
                           "c": jnp.zeros((self.in_dim,))}}

    def apply(self, params, x):
        p = params["params"]
        return jnp.exp(-p["b"] * (x - p["c"]) ** 2)


def _mlp_init(key, sizes: Sequence[int], dtype):
    """``{"Dense_i": {"kernel", "bias"}}`` for a Dense stack ``sizes[0] ->
    sizes[1] -> ...``."""
    keys = jax.random.split(key, len(sizes) - 1)
    return {f"Dense_{i}": {"kernel": _lecun_normal(k, (a, b), dtype),
                           "bias": jnp.zeros((b,), dtype)}
            for i, (k, a, b) in enumerate(zip(keys, sizes[:-1], sizes[1:]))}


def _mlp(p, x, bf16: bool, tanh_last: bool = False):
    """Dense stack with Tanh between layers (and after the last one when
    ``tanh_last``)."""
    n = len(p)
    for i in range(n):
        layer = p[f"Dense_{i}"]
        x = matmul(x, layer["kernel"], bf16) + layer["bias"]
        if i < n - 1 or tanh_last:
            x = jnp.tanh(x)
    return x


def _transform(p, latent, k: int, bf16: bool):
    """Global latent -> near-identity (k, k) transform, I + A
    (model_pn.py:70-86)."""
    a = _mlp(p["MLP_0"], latent, bf16)
    return jnp.eye(k, dtype=latent.dtype) + a.reshape(k, k)


@dataclasses.dataclass(frozen=True)
class DynamicsNetwork:
    """Full delta-prediction network (model_pn.py:176-278).

    Inputs are padded ``(N, ...)`` per-Gaussian quantities plus an ``(N,)`` active
    mask and an ``(N, N)`` neighbor mask; output deltas are zero on inactive slots.
    Hashable, so it can be a static argument of ``jax.jit``.

    ``bf16_products``: every float32 matrix product of the network (dense
    layers, transforms, factored aggregation) takes one bfloat16 pass with
    float32 accumulation, forward and backward, on every backend
    (:func:`pigs_tpu.ops.matmul.matmul`).  The committed checkpoints were
    trained at this precision, and the flagship's rollout reproduces at it
    (PERF.md).  ``False``: exact float32 products.
    """

    c: int
    d: int
    pde_size: int
    width_mult: int = 1   # scales every hidden width (1 = reference sizes;
                          # EMBEDDING_SIZE is positional and stays fixed)
    bf16_products: bool = True

    def _sizes(self):
        m = self.width_mult
        return LATENT_SIZE * m, L1_SIZE * m, L2_SIZE * m, L3_SIZE * m

    def _transform_sizes(self):
        d, c, p = self.d, self.c, self.pde_size
        return {"transform_net": d, "transform_u_net": c,
                "transform_ux_net": d * c, "transform_uxx_net": d * c,
                "transform_pde_net": p}

    def init(self, key: jax.Array, dtype=jnp.float32):
        """Fresh parameters ``{"params": {...}}``."""
        d, c, p = self.d, self.c, self.pde_size
        LATENT, L1, L2, L3 = self._sizes()
        # Per-Gaussian inputs: means, covariance, u, boundary flag, sampled
        # u / ux / diag(uxx) / pde features (InputTransform's concatenation).
        n_in = d + d * d + c + 1 + c + d * c + d * c + p
        mid = (LATENT + L1) // 2
        out_size = d + d + d * (d - 1) // 2 + c
        keys = iter(jax.random.split(key, 16 + 4 * ATTENTION_HEADS))

        it = {"latent_net": _mlp_init(next(keys),
                                      [n_in, L1_SIZE, L2_SIZE, LATENT_SIZE],
                                      dtype)}
        for name, k in self._transform_sizes().items():
            it[name] = {"MLP_0": _mlp_init(
                next(keys), [LATENT_SIZE, L3_SIZE, L2_SIZE, k * k], dtype)}
        params = {"InputTransform_0": it,
                  "input_projection": _mlp_init(
                      next(keys), [n_in - d, L1, L2, L3, LATENT], dtype)}
        uniform = jax.nn.initializers.uniform(scale=2.0)
        for h in range(ATTENTION_HEADS):
            params[f"transform_{h}"] = uniform(next(keys), (LATENT, LATENT),
                                               dtype)
            params[f"distance_transform_{h}"] = uniform(
                next(keys), (LATENT, EMBEDDING_SIZE * 2), dtype)
            for name in (f"query_{h}", f"key_{h}"):
                params[name] = _mlp_init(
                    next(keys), [LATENT, LATENT, LATENT, mid, L1], dtype)
        l = ATTENTION_HEADS // 2 + 1
        params["delta_net"] = _mlp_init(
            next(keys), [LATENT * (1 + ATTENTION_HEADS), l * LATENT, LATENT,
                         LATENT, L3, L2, out_size], dtype)
        return {"params": params}

    def _input_transform(self, p, means, full_cov, u, boundaries, sample_u,
                         sample_ux, sample_uxx, sample_pde, active):
        """Learned canonical transforms applied to all per-Gaussian quantities
        (model_pn.py:88-152)."""
        n = means.shape[0]
        cov_flat = full_cov.reshape(n, self.d * self.d)
        x = jnp.concatenate(
            [means, cov_flat, u, boundaries[:, None].astype(u.dtype),
             sample_u, sample_ux, sample_uxx, sample_pde], axis=-1)
        bf16 = self.bf16_products
        per_gaussian = _mlp(p["latent_net"], x, bf16,
                            tanh_last=True)                  # (N, LATENT)
        # Masked mean-pool over *active* Gaussians (replaces .mean(-1) over a
        # variable-length axis, model_pn.py:114).
        w = active.astype(per_gaussian.dtype)[:, None]
        latent = jnp.sum(per_gaussian * w, axis=0) / jnp.maximum(jnp.sum(w), 1.0)

        t = {name: _transform(p[name], latent, k, bf16)
             for name, k in self._transform_sizes().items()}
        t_u = t["transform_u_net"]
        # transform_net @ full_cov[i] for every i, as (cov^T @ T^T)^T.
        t_cov = matmul(jnp.swapaxes(full_cov, 1, 2), t["transform_net"].T,
                       bf16)
        return (
            jnp.swapaxes(t_cov, 1, 2).reshape(n, -1),
            matmul(u, t_u.T, bf16),
            matmul(sample_u, t_u.T, bf16),
            matmul(sample_ux, t["transform_ux_net"].T, bf16),
            matmul(sample_uxx, t["transform_uxx_net"].T, bf16),
            matmul(sample_pde, t["transform_pde_net"].T, bf16),
        )

    def apply(self, params, means, full_cov, u, boundaries, sample_u,
              sample_ux, sample_uxx, sample_pde, active, nbr_mask,
              period: Optional[float] = None) -> Deltas:
        p = params["params"]
        n, d = means.shape
        transform_size = d * (d - 1) // 2
        dtype = means.dtype

        t_cov, t_u, t_sample_u, t_ux, t_uxx, t_pde = self._input_transform(
            p["InputTransform_0"], means, full_cov, u, boundaries, sample_u,
            sample_ux, sample_uxx, sample_pde, active)

        t_params = jnp.concatenate(
            [t_cov, t_u, boundaries[:, None].astype(dtype), t_sample_u,
             t_ux, t_uxx, t_pde], axis=-1)

        bf16 = self.bf16_products
        features = _mlp(p["input_projection"], t_params, bf16)  # (N, LATENT)

        # Fixed random sinusoidal frequencies (model_pn.py:227-230,
        # requires_grad=False): deterministic constants, not parameters.
        freq_size = (EMBEDDING_SIZE - 1) // d // 2
        frequencies = (jax.random.normal(
            jax.random.PRNGKey(42), (freq_size,)) * 10.0).astype(dtype)

        all_features = [features]
        magnitudes = []
        for h in range(ATTENTION_HEADS):
            transform = p[f"transform_{h}"] - 1.0  # U[-1, 1) like torch.rand*2-1
            distance_transform = p[f"distance_transform_{h}"] - 1.0
            queries = _mlp(p[f"query_{h}"], features, bf16)
            keys = _mlp(p[f"key_{h}"], features, bf16)
            # The factored (angle-addition) formulation: all matmuls, no
            # per-pair transcendentals, and exactly the dense semantics
            # (tests/test_aggregate.py).
            agg = aggregate_neighbors_factored(
                features, transform.astype(dtype), queries, keys,
                frequencies, distance_transform.astype(dtype),
                means=means, mask=nbr_mask, period=period,
                bf16_products=bf16)
            magnitudes.append(jnp.mean(agg ** 2))
            all_features.append(agg)

        local_global = jnp.concatenate(all_features, axis=-1)
        deltas = _mlp(p["delta_net"], local_global, bf16)

        gate = active.astype(dtype)[:, None]
        dmeans = deltas[:, :d] * gate
        dscaling = deltas[:, d:2 * d] * gate
        dtransforms = deltas[:, 2 * d:2 * d + transform_size] * gate
        du = deltas[:, 2 * d + transform_size:] * gate
        return Deltas(dmeans, dscaling, dtransforms, du,
                      jnp.stack(magnitudes))
