"""Fused Pallas kernels (Triton route) for 2D Gaussian-mixture field evaluation.

The fused path for the framework's hot primitive (the reference's CUDA
``sample_gaussians*`` family, SURVEY.md §2.1): one pass over (sample x Gaussian)
pairs computes the density once and emits value, gradient, Hessian and third
derivative together, keeping every per-pair intermediate in registers.  The
blockwise XLA path (``ops/mixture.py``) instead writes (chunk, n, d^order, c)
intermediates to device memory.

Design (NVIDIA Hopper, every ``pallas_call`` on ``backend="triton"``):

  * structure-of-arrays inputs: sample x and y as length-m vectors, Gaussian
    parameters as rows of length n (means x/y, packed conic [cxx, cxy, cyy],
    one row per value channel).  Ragged m and n are zero-padded to the block
    sizes; padded Gaussians carry value 0 and contribute nothing.
  * the grid covers output tiles only.  The reduced axis is an in-kernel
    ``lax.fori_loop`` with a Kahan-compensated sum carried in registers.  Blocks
    run in parallel and in no order, so nothing is carried between them.
  * when the output tiles alone give too few blocks to fill the card, a second
    grid axis splits the reduced axis into segments; each block writes its
    segment's partial sum and XLA adds the partials (``segments``).
  * the contraction over channels (c <= 2 in every configuration) is a multiply
    and a row or column sum; no matrix unit is involved.
  * symmetric tensors are packed: conic [cxx, cxy, cyy]; Hessian output
    [xx, xy, yy]; third derivative [xxx, xxy, xyy, yyy].  The wrapper unpacks to
    the oracle's full shapes and folds symmetric cotangents back down.
  * the backward pass is two kernels with transposed reductions:
    Gaussian-parameter grads reduce over samples, sample grads over Gaussians.
    The adjoint is hand-derived (``_adjoint``), with the density recomputed
    instead of stored.  ``diff_samples=False`` skips the sample-grad kernel.
  * second-order differentiation goes through the dense oracle (``_bwd_op``).

``interpret=True`` runs the same kernels through the Pallas interpreter (CPU
tests); it is never chosen implicitly.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pigs_tpu.ops.oracle import MixtureFields

__all__ = ["eval_mixture_pallas", "segments"]

# Launch settings, swept on an H100 SXM (700 W) at the bring-up shapes (see
# PERF.md).  Block sizes must be powers of two on the Triton route.
FWD_BLOCK_M = 64       # samples per block (grid axis)
FWD_BLOCK_N = 16       # Gaussians per loop iteration
FWD_WARPS = 2
BWD_BLOCK_M = 32       # samples per loop iteration of the parameter-grad kernel
BWD_WARPS = 4
NUM_STAGES = 1


def bwd_block_n(c: int, order: int) -> int:
    """Gaussians per block of the parameter-grad kernel: 128 while the live
    set is small (c * (order + 1) <= 3, e.g. c=1 up to order 2); wider
    outputs spill at 128 (5x slower at c=2, order 3), so they take 64."""
    return 128 if c * (order + 1) <= 3 else 64


# Blocks worth keeping in flight: a few per SM (132 SMs on an H100 SXM), so
# that one block's loads overlap another's arithmetic.
TARGET_BLOCKS = 4 * 132

N_COMP = (1, 3, 6, 10)     # packed components up to each derivative order
GROUP_SIZES = (1, 2, 3, 4)  # components per order


def segments(out_tiles: int, red_tiles: int,
             target_blocks: int = TARGET_BLOCKS):
    """Split of the reduced axis: (number of segments, tiles per segment).

    ``out_tiles`` blocks come from the output axis; each gets ``segments``
    blocks along the reduced axis so that about ``target_blocks`` run at once.
    """
    want = max(1, -(-target_blocks // max(out_tiles, 1)))
    per_seg = max(1, -(-red_tiles // min(want, red_tiles)))
    return -(-red_tiles // per_seg), per_seg


def _round_half_even(x):
    """``jnp.round`` (half to even) from floor and select: the Triton route has
    no rounding primitive, and the oracle wraps with ``jnp.round``."""
    f = jnp.floor(x)
    diff = x - f
    odd = (f - 2.0 * jnp.floor(0.5 * f)) != 0.0
    up = (diff > 0.5) | ((diff == 0.5) & odd)
    return jnp.where(up, f + 1.0, f)


def _geometry(x, y, mx, my, cxx, cxy, cyy, period: Optional[float]):
    """Per-pair displacement, conic product p = C delta and density g.
    Sample quantities are columns (bm, 1), Gaussian ones rows (1, bn)."""
    dx = x - mx
    dy = y - my
    if period is not None:
        inv = 1.0 / period
        dx = dx - period * _round_half_even(dx * inv)
        dy = dy - period * _round_half_even(dy * inv)
    px = cxx * dx + cxy * dy
    py = cxy * dx + cyy * dy
    g = jnp.exp(-0.5 * (dx * px + dy * py))
    return dx, dy, px, py, g, cxx, cxy, cyy


def _polys(geom, order: int):
    """The packed output polynomials P_k, with output k = sum_i P_k g_i v_i
    (analytic derivative formulas of reference gaussians.py:89-116 and the
    third-derivative tensor, model_pn.py:654-656).  P_0 = 1 is None."""
    dx, dy, px, py, g, cxx, cxy, cyy = geom
    polys = [None]
    if order >= 1:
        polys += [-px, -py]
    if order >= 2:
        polys += [px * px - cxx, px * py - cxy, py * py - cyy]
    if order >= 3:
        polys += [3.0 * cxx * px - px * px * px,
                  cxx * py + 2.0 * cxy * px - px * px * py,
                  cyy * px + 2.0 * cxy * py - px * py * py,
                  3.0 * cyy * py - py * py * py]
    return polys


def _adjoint(geom, rs, order: int, need_conic: bool):
    """Hand-derived adjoint fields.

    ``rs`` are the cotangent weights r_k per packed component (ordered like
    ``_polys``).  Each output is W_k = P_k(p, C) g with g = exp(-1/2 d.C d),
    p = C d.  With T = sum_k r_k W_k, its derivative w.r.t. any pair scalar
    theta is

        E_theta = g [ Q dpx/dtheta + R dpy/dtheta + (direct dP/dC terms)
                      + A dlog(g)/dtheta ]

    with Q = sum_k r_k dP_k/dpx, R = sum_k r_k dP_k/dpy, A = sum_k r_k P_k.
    Gaussian-parameter grads are column sums of E (means with a sign flip);
    sample grads are row sums of (E_dx, E_dy).

    Returns (E_dx, E_dy, E_cxx, E_cxy, E_cyy, A g); the conic fields are None
    unless ``need_conic``.
    """
    dx, dy, px, py, g, cxx, cxy, cyy = geom
    A = rs[0]
    Q = R = Dxx = Dxy = Dyy = 0.0
    if order >= 1:
        r_x, r_y = rs[1], rs[2]
        Q = -r_x
        R = -r_y
        A = A - px * r_x - py * r_y
    if order >= 2:
        r_xx, r_xy, r_yy = rs[3], rs[4], rs[5]
        Q = Q + 2.0 * px * r_xx + py * r_xy
        R = R + px * r_xy + 2.0 * py * r_yy
        A = A + ((px * px - cxx) * r_xx + (px * py - cxy) * r_xy
                 + (py * py - cyy) * r_yy)
        Dxx, Dxy, Dyy = -r_xx, -r_xy, -r_yy
    if order >= 3:
        r_xxx, r_xxy, r_xyy, r_yyy = rs[6:10]
        Q = Q + ((3.0 * cxx - 3.0 * px * px) * r_xxx
                 + (2.0 * cxy - 2.0 * px * py) * r_xxy
                 + (cyy - py * py) * r_xyy)
        R = R + ((cxx - px * px) * r_xxy
                 + (2.0 * cxy - 2.0 * px * py) * r_xyy
                 + (3.0 * cyy - 3.0 * py * py) * r_yyy)
        A = A + ((3.0 * cxx * px - px * px * px) * r_xxx
                 + (cxx * py + 2.0 * cxy * px - px * px * py) * r_xxy
                 + (cyy * px + 2.0 * cxy * py - px * py * py) * r_xyy
                 + (3.0 * cyy * py - py * py * py) * r_yyy)
        Dxx = Dxx + 3.0 * px * r_xxx + py * r_xxy
        Dxy = Dxy + 2.0 * px * r_xxy + 2.0 * py * r_xyy
        Dyy = Dyy + px * r_xyy + 3.0 * py * r_yyy

    E_dx = g * (Q * cxx + R * cxy - A * px)
    E_dy = g * (Q * cxy + R * cyy - A * py)
    E_cxx = E_cxy = E_cyy = None
    if need_conic:
        E_cxx = g * (Q * dx + Dxx - 0.5 * A * dx * dx)
        E_cxy = g * (Q * dy + R * dx + Dxy - A * dx * dy)
        E_cyy = g * (R * dy + Dyy - 0.5 * A * dy * dy)
    return E_dx, E_dy, E_cxx, E_cxy, E_cyy, A * g


def _kahan(carry, incs):
    """Compensated accumulation of ``incs`` into the flat (sum, comp) carry."""
    out = []
    for k, inc in enumerate(incs):
        s, comp = carry[2 * k], carry[2 * k + 1]
        y = inc - comp
        t = s + y
        out += [t, (t - s) - y]
    return tuple(out)


def _segment_loop(body, n_acc, size, seg, per_seg, n_tiles):
    """Run ``body(tile, carry)`` over this block's segment of the reduced axis
    with ``n_acc`` Kahan-carried accumulators of length ``size``."""
    zeros = jnp.zeros((size,), jnp.float32)
    lo = seg * per_seg
    hi = jnp.minimum(lo + per_seg, n_tiles)
    carry = jax.lax.fori_loop(lo, hi, body, (zeros,) * (2 * n_acc))
    return carry[0::2]


# ---------------------------------------------------------------- forward ----


def _fwd_kernel(x_ref, y_ref, mx_ref, my_ref, cxx_ref, cxy_ref, cyy_ref, v_ref,
                o_ref, *, order, period, c, bn, per_seg, n_tiles):
    x = x_ref[...][:, None]
    y = y_ref[...][:, None]
    polys_count = N_COMP[order]

    def body(t, carry):
        sl = pl.ds(pl.multiple_of(t * bn, bn), bn)
        row = lambda ref: ref[sl][None, :]
        geom = _geometry(x, y, row(mx_ref), row(my_ref), row(cxx_ref),
                         row(cxy_ref), row(cyy_ref), period)
        polys = _polys(geom, order)
        incs = [None] * (polys_count * c)
        for ch in range(c):
            gv = geom[4] * v_ref[ch, sl][None, :]
            for k, p in enumerate(polys):
                incs[k * c + ch] = jnp.sum(gv if p is None else p * gv, axis=1)
        return _kahan(carry, incs)

    sums = _segment_loop(body, polys_count * c, x_ref.shape[0],
                         pl.program_id(1), per_seg, n_tiles)
    for k, s in enumerate(sums):
        o_ref[k, :] = s


def _pad_to(x, mult, axis=-1):
    size = x.shape[axis]
    target = -(-size // mult) * mult
    if target == size:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return jnp.pad(x, widths)


def _soa(means, conics_packed, values, samples, mult_m, mult_n):
    """Structure-of-arrays f32 operands, padded: x, y (mp,); mx, my, cxx, cxy,
    cyy (np,); v (c, np)."""
    f32 = jnp.float32
    smp = _pad_to(samples.astype(f32).T, mult_m)
    gauss = _pad_to(jnp.concatenate([means.T, conics_packed.T], axis=0)
                    .astype(f32), mult_n)
    v = _pad_to(values.T.astype(f32), mult_n)
    return (smp[0], smp[1]), tuple(gauss), v


def _params(num_warps):
    return pltriton.CompilerParams(num_warps=num_warps, num_stages=NUM_STAGES)


@functools.partial(jax.jit, static_argnames=(
    "order", "period", "interpret", "block_m", "block_n", "num_warps"))
def _pallas_forward(means, conics_packed, values, samples, order: int,
                    period: Optional[float], interpret: bool = False,
                    block_m: int = FWD_BLOCK_M, block_n: int = FWD_BLOCK_N,
                    num_warps: int = FWD_WARPS):
    """Packed outputs (m, G*c) per order group, as ``_unpack_fields`` takes."""
    m, c = samples.shape[0], values.shape[1]
    (x, y), gauss, v = _soa(means, conics_packed, values, samples,
                            block_m, block_n)
    mp, np_ = x.shape[0], v.shape[1]
    m_tiles, n_tiles = mp // block_m, np_ // block_n
    n_seg, per_seg = segments(m_tiles, n_tiles)
    rows = N_COMP[order] * c

    samp_spec = pl.BlockSpec((block_m,), lambda i, s: (i,))
    full = pl.BlockSpec((np_,), lambda i, s: (0,))
    out = pl.pallas_call(
        functools.partial(_fwd_kernel, order=order, period=period, c=c,
                          bn=block_n, per_seg=per_seg, n_tiles=n_tiles),
        grid=(m_tiles, n_seg),
        in_specs=[samp_spec, samp_spec] + [full] * 5
        + [pl.BlockSpec((c, np_), lambda i, s: (0, 0))],
        out_specs=pl.BlockSpec((None, rows, block_m), lambda i, s: (s, 0, i)),
        out_shape=jax.ShapeDtypeStruct((n_seg, rows, mp), jnp.float32),
        backend="triton",
        compiler_params=_params(num_warps),
        interpret=interpret,
        name="mixture_fwd",
        cost_estimate=pl.CostEstimate(
            flops=mp * np_ * (12 + 4 * rows),
            bytes_accessed=4 * (2 * mp + (5 + c) * np_ + n_seg * rows * mp),
            transcendentals=mp * np_),
    )(x, y, *gauss, v)
    flat = jnp.sum(out, axis=0).T[:m]                      # (m, rows)
    outs, row = [], 0
    for gsize in GROUP_SIZES[:order + 1]:
        outs.append(flat[:, row * c:(row + gsize) * c])
        row += gsize
    return outs


# ---------------------------------------------------------------- backward ---


def _bwd_gauss_kernel(x_ref, y_ref, cot_ref, mx_ref, my_ref, cxx_ref, cxy_ref,
                      cyy_ref, o_ref, *, order, period, c, bm, per_seg,
                      n_tiles):
    """Per-channel column sums of (E_dx, E_dy, E_cxx, E_cxy, E_cyy, A g) with
    r_k = cotangent_k (the value factor v is applied by the wrapper: it is
    constant along this kernel's reduction)."""
    gauss = [ref[...][None, :] for ref in (mx_ref, my_ref, cxx_ref, cxy_ref,
                                           cyy_ref)]
    n_comp = N_COMP[order]

    def body(t, carry):
        sl = pl.ds(pl.multiple_of(t * bm, bm), bm)
        geom = _geometry(x_ref[sl][:, None], y_ref[sl][:, None], *gauss,
                         period)
        incs = []
        for ch in range(c):
            rs = [cot_ref[k * c + ch, sl][:, None] for k in range(n_comp)]
            fields = _adjoint(geom, rs, order, need_conic=True)
            incs += [jnp.sum(f, axis=0) for f in fields]
        return _kahan(carry, incs)

    sums = _segment_loop(body, 6 * c, mx_ref.shape[0], pl.program_id(1),
                         per_seg, n_tiles)
    for k, s in enumerate(sums):
        o_ref[k, :] = s


def _bwd_sample_kernel(x_ref, y_ref, cot_ref, mx_ref, my_ref, cxx_ref,
                       cxy_ref, cyy_ref, v_ref, o_ref, *, order, period, c,
                       bn, per_seg, n_tiles):
    """Row sums of (E_dx, E_dy) with the value factor folded into g
    (d delta / d sample = +1)."""
    x = x_ref[...][:, None]
    y = y_ref[...][:, None]
    n_comp = N_COMP[order]
    rs_ch = [[cot_ref[k * c + ch, :][:, None] for k in range(n_comp)]
             for ch in range(c)]

    def body(t, carry):
        sl = pl.ds(pl.multiple_of(t * bn, bn), bn)
        row = lambda ref: ref[sl][None, :]
        geom = _geometry(x, y, row(mx_ref), row(my_ref), row(cxx_ref),
                         row(cxy_ref), row(cyy_ref), period)
        gx = gy = 0.0
        for ch in range(c):
            g_v = geom[4] * v_ref[ch, sl][None, :]
            fields = _adjoint(geom[:4] + (g_v,) + geom[5:], rs_ch[ch], order,
                              need_conic=False)
            gx = gx + jnp.sum(fields[0], axis=1)
            gy = gy + jnp.sum(fields[1], axis=1)
        return _kahan(carry, (gx, gy))

    sums = _segment_loop(body, 2, x_ref.shape[0], pl.program_id(1), per_seg,
                         n_tiles)
    o_ref[0, :] = sums[0]
    o_ref[1, :] = sums[1]


@functools.partial(jax.jit, static_argnames=(
    "order", "period", "diff_samples", "interpret", "block_n", "block_m",
    "num_warps"))
def _pallas_backward(means, conics_packed, values, samples, cots, order: int,
                     period: Optional[float], diff_samples: bool = True,
                     interpret: bool = False, block_n: Optional[int] = None,
                     block_m: int = BWD_BLOCK_M, num_warps: int = BWD_WARPS):
    """cots: packed cotangents (m, c), (m, 2c), (m, 3c), (m, 4c) up to
    ``order``.  Returns (gm (n, 2), gc packed (n, 3), gv (n, c), gx (m, 2)).

    ``diff_samples=False`` skips the sample-grad kernel and returns zeros for
    gx: collocation points are constants in every training loop.
    """
    m, n, c = samples.shape[0], means.shape[0], values.shape[1]
    f32 = jnp.float32
    block_n = block_n or bwd_block_n(c, order)
    mult = max(block_m, FWD_BLOCK_M)
    (x, y), gauss, v = _soa(means, conics_packed, values, samples, mult,
                            max(block_n, FWD_BLOCK_N))
    mp, np_ = x.shape[0], v.shape[1]
    # Rows component-major, channel-minor: row k*c + ch.
    cot = _pad_to(jnp.concatenate(cots, axis=1).astype(f32).T, mult)
    rows_cot = cot.shape[0]

    # Kernel 1: Gaussian-parameter grads (reduce over samples).
    g_tiles, s_tiles = np_ // block_n, mp // block_m
    n_seg, per_seg = segments(g_tiles, s_tiles)
    full_m = pl.BlockSpec((mp,), lambda j, s: (0,))
    gauss_spec = pl.BlockSpec((block_n,), lambda j, s: (j,))
    acc = pl.pallas_call(
        functools.partial(_bwd_gauss_kernel, order=order, period=period, c=c,
                          bm=block_m, per_seg=per_seg, n_tiles=s_tiles),
        grid=(g_tiles, n_seg),
        in_specs=[full_m, full_m,
                  pl.BlockSpec((rows_cot, mp), lambda j, s: (0, 0))]
        + [gauss_spec] * 5,
        out_specs=pl.BlockSpec((None, 6 * c, block_n),
                               lambda j, s: (s, 0, j)),
        out_shape=jax.ShapeDtypeStruct((n_seg, 6 * c, np_), f32),
        backend="triton",
        compiler_params=_params(num_warps),
        interpret=interpret,
        name="mixture_bwd_gauss",
        cost_estimate=pl.CostEstimate(
            flops=mp * np_ * c * (40 + 24 * order),
            bytes_accessed=4 * ((2 + rows_cot) * mp + 5 * np_
                                + n_seg * 6 * c * np_),
            transcendentals=mp * np_),
    )(x, y, cot, *gauss)
    acc = jnp.sum(acc, axis=0)[:, :n].reshape(c, 6, n)    # (c, 6, n)
    vt = values.T.astype(f32)[:, None, :]                   # (c, 1, n)
    weighted = jnp.sum(acc[:, :5] * vt, axis=0)              # (5, n)
    gm = -weighted[:2].T
    gc = weighted[2:5].T
    gv = acc[:, 5].T

    if not diff_samples:
        return gm, gc, gv, jnp.zeros((m, 2), f32)

    # Kernel 2: sample grads (reduce over Gaussians).
    m_tiles, n_tiles = mp // FWD_BLOCK_M, np_ // FWD_BLOCK_N
    n_seg, per_seg = segments(m_tiles, n_tiles)
    samp_spec = pl.BlockSpec((FWD_BLOCK_M,), lambda i, s: (i,))
    full_n = pl.BlockSpec((np_,), lambda i, s: (0,))
    gx = pl.pallas_call(
        functools.partial(_bwd_sample_kernel, order=order, period=period, c=c,
                          bn=FWD_BLOCK_N, per_seg=per_seg, n_tiles=n_tiles),
        grid=(m_tiles, n_seg),
        in_specs=[samp_spec, samp_spec,
                  pl.BlockSpec((rows_cot, FWD_BLOCK_M), lambda i, s: (0, i))]
        + [full_n] * 5 + [pl.BlockSpec((c, np_), lambda i, s: (0, 0))],
        out_specs=pl.BlockSpec((None, 2, FWD_BLOCK_M), lambda i, s: (s, 0, i)),
        out_shape=jax.ShapeDtypeStruct((n_seg, 2, mp), f32),
        backend="triton",
        compiler_params=_params(FWD_WARPS),
        interpret=interpret,
        name="mixture_bwd_samples",
        cost_estimate=pl.CostEstimate(
            flops=mp * np_ * c * (30 + 20 * order),
            bytes_accessed=4 * ((2 + rows_cot) * mp + (5 + c) * np_
                                + n_seg * 2 * mp),
            transcendentals=mp * np_),
    )(x, y, cot, *gauss, v)
    return gm, gc, gv, jnp.sum(gx, axis=0).T[:m]


# ------------------------------------------------------------- public API ----


def _pack_conics(conics_full):
    return jnp.stack([conics_full[:, 0, 0], conics_full[:, 0, 1],
                      conics_full[:, 1, 1]], axis=-1)


def _unpack_fields(outs, m, c, order):
    u = outs[0]
    ux = uxx = uxxx = None
    if order >= 1:
        ux = outs[1].reshape(m, 2, c)
    if order >= 2:
        p = outs[2].reshape(m, 3, c)
        uxx = jnp.stack([
            jnp.stack([p[:, 0], p[:, 1]], axis=1),
            jnp.stack([p[:, 1], p[:, 2]], axis=1),
        ], axis=1)
    if order >= 3:
        q = outs[3].reshape(m, 4, c)
        uxxx = jnp.stack([
            jnp.stack([jnp.stack([q[:, 0], q[:, 1]], axis=1),
                       jnp.stack([q[:, 1], q[:, 2]], axis=1)], axis=1),
            jnp.stack([jnp.stack([q[:, 1], q[:, 2]], axis=1),
                       jnp.stack([q[:, 2], q[:, 3]], axis=1)], axis=1),
        ], axis=1)
    return MixtureFields(u=u, ux=ux, uxx=uxx, uxxx=uxxx)


def _pack_cotangents(fields_bar, m, c, order):
    """Fold full-tensor cotangents down to the packed kernel outputs, summing
    the symmetric positions that were broadcast from one packed component."""
    zeros = lambda w: jnp.zeros((m, w), jnp.float32)
    cots = [fields_bar.u if fields_bar.u is not None else zeros(c)]
    if order >= 1:
        b = fields_bar.ux
        cots.append(b.reshape(m, 2 * c) if b is not None else zeros(2 * c))
    if order >= 2:
        b = fields_bar.uxx
        if b is None:
            cots.append(zeros(3 * c))
        else:
            packed = jnp.stack([b[:, 0, 0], b[:, 0, 1] + b[:, 1, 0],
                                b[:, 1, 1]], axis=1)
            cots.append(packed.reshape(m, 3 * c))
    if order >= 3:
        b = fields_bar.uxxx
        if b is None:
            cots.append(zeros(4 * c))
        else:
            packed = jnp.stack([
                b[:, 0, 0, 0],
                b[:, 0, 0, 1] + b[:, 0, 1, 0] + b[:, 1, 0, 0],
                b[:, 0, 1, 1] + b[:, 1, 0, 1] + b[:, 1, 1, 0],
                b[:, 1, 1, 1],
            ], axis=1)
            cots.append(packed.reshape(m, 4 * c))
    return tuple(cots)


@functools.partial(jax.custom_vjp, nondiff_argnums=(4, 5, 6, 7))
def _eval_core(means, conics_full, values, samples, order, period,
               diff_samples, interpret):
    outs = _pallas_forward(means, _pack_conics(conics_full), values, samples,
                           order, period, interpret)
    m, c = samples.shape[0], values.shape[1]
    return _unpack_fields(outs, m, c, order)


def _core_fwd(means, conics_full, values, samples, order, period,
              diff_samples, interpret):
    out = _eval_core(means, conics_full, values, samples, order, period,
                     diff_samples, interpret)
    return out, (means, conics_full, values, samples)


def _sym_full(gc_packed):
    """Packed conic grads -> full symmetric: the off-diagonal splits evenly
    (the kernel's 2*cxy*dx*dy corresponds to C01 + C10 in the full form)."""
    return jnp.stack([
        jnp.stack([gc_packed[:, 0], 0.5 * gc_packed[:, 1]], axis=-1),
        jnp.stack([0.5 * gc_packed[:, 1], gc_packed[:, 2]], axis=-1),
    ], axis=-2)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1, 2, 3))
def _bwd_op(order, period, diff_samples, interpret, primals, fields_bar):
    """The first-order backward as a differentiable op.

    Forward value: the fused backward kernels.  Its OWN vjp (i.e.
    second-order differentiation, the reference's create_graph=True,
    test_derivatives.py:122-129) differentiates the dense oracle's vjp of the
    same mapping instead — exact, plain XLA AD, used only when grad-of-grad
    is actually requested.

    Memory: the dense double-backward materializes O(m*n) pairwise
    intermediates (tens of arrays), so beyond
    ``SECOND_ORDER_PAIR_BUDGET`` sample-Gaussian pairs the vjp is computed
    in sample chunks under ``lax.map`` (exact — the second-order cotangents
    are sums of per-sample contributions).  At 65536x2048 this caps the
    working set at ~1 GB instead of ~0.5 TB."""
    means, conics_full, values, samples = primals
    m, c = samples.shape[0], values.shape[1]
    cots = _pack_cotangents(fields_bar, m, c, order)
    gm, gc_packed, gv, gx = _pallas_backward(
        means, _pack_conics(conics_full), values, samples, cots, order,
        period, diff_samples, interpret)
    return (gm.astype(means.dtype), _sym_full(gc_packed).astype(
        conics_full.dtype), gv.astype(values.dtype), gx.astype(samples.dtype))


def _bwd_op_ref(order, period, diff_samples, primals, fields_bar):
    """Dense-oracle implementation of the same (primals, cotangents) ->
    gradients mapping, with the kernel path's conic symmetrization."""
    from pigs_tpu.ops.oracle import eval_mixture_dense
    means, conics_full, values, samples = primals

    def f(m_, c_, v_, s_):
        out = eval_mixture_dense(m_, c_, v_, s_, order=order, period=period)
        return tuple(x for x in out[:order + 1])

    _, vjp = jax.vjp(f, means, conics_full, values, samples)
    bar = tuple(fields_bar[:order + 1])
    gm, gc, gv, gx = vjp(bar)
    gc = 0.5 * (gc + jnp.swapaxes(gc, -1, -2))
    if not diff_samples:
        gx = jnp.zeros_like(gx)
    return gm, gc, gv, gx


def _bwd_op_fwd(order, period, diff_samples, interpret, primals, fields_bar):
    out = _bwd_op(order, period, diff_samples, interpret, primals, fields_bar)
    return out, (primals, fields_bar)


# Max sample-Gaussian pairs one dense second-order vjp block may
# materialize (~30 (m,n)-sized f32 intermediates -> ~1 GB at this budget).
SECOND_ORDER_PAIR_BUDGET = 1 << 23


def _bwd_op_bwd(order, period, diff_samples, interpret, res, grad_out):
    del interpret  # the double backward is plain XLA
    primals, fields_bar = res
    means, conics_full, values, samples = primals
    m, n = samples.shape[0], means.shape[0]

    def full(p, fb):
        return _bwd_op_ref(order, period, diff_samples, p, fb)

    if m * n <= SECOND_ORDER_PAIR_BUDGET:
        _, vjp2 = jax.vjp(full, primals, fields_bar)
        return vjp2(grad_out)

    # Chunk over samples: (gm, gc, gv) are sums of per-sample contributions
    # and gx is per-sample, so the vjp splits exactly across sample chunks —
    # shared primal cotangents sum, per-sample cotangents concatenate.
    chunk = max(SECOND_ORDER_PAIR_BUDGET // n, 1)
    k = -(-m // chunk)
    pad = k * chunk - m

    def split_rows(x):
        x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
        return x.reshape((k, chunk) + x.shape[1:])

    gm_bar, gc_bar, gv_bar, gx_bar = grad_out

    def chunk_fn(xs):
        samples_c, fb_c, gxb_c = xs
        _, vjp2 = jax.vjp(full, (means, conics_full, values, samples_c), fb_c)
        return vjp2((gm_bar, gc_bar, gv_bar, gxb_c))

    (mb, cb, vb, sb), fbb = jax.lax.map(
        chunk_fn, (split_rows(samples),
                   jax.tree_util.tree_map(split_rows, fields_bar),
                   split_rows(gx_bar)))

    def unsplit_rows(x):
        return x.reshape((-1,) + x.shape[2:])[:m]

    return ((mb.sum(0), cb.sum(0), vb.sum(0), unsplit_rows(sb)),
            jax.tree_util.tree_map(unsplit_rows, fbb))


_bwd_op.defvjp(_bwd_op_fwd, _bwd_op_bwd)


def _core_bwd(order, period, diff_samples, interpret, res, fields_bar):
    means, conics_full, values, samples = res
    m, c = samples.shape[0], values.shape[1]
    # Fix the cotangent pytree structure (None -> zeros) so _bwd_op's
    # signature is static.
    widths_full = [(m, c), (m, 2, c), (m, 2, 2, c), (m, 2, 2, 2, c)]
    bars = []
    for k, b in enumerate(tuple(fields_bar)[:order + 1]):
        bars.append(b if b is not None
                    else jnp.zeros(widths_full[k], jnp.float32))
    bars += [None] * (4 - len(bars))
    return _bwd_op(order, period, diff_samples, interpret,
                   (means, conics_full, values, samples),
                   MixtureFields(*bars))


_eval_core.defvjp(_core_fwd, _core_bwd)


def eval_mixture_pallas(
    means: jax.Array,
    conics: jax.Array,
    values: jax.Array,
    samples: jax.Array,
    order: int = 0,
    mask: Optional[jax.Array] = None,
    period: Optional[float] = None,
    diff_samples: bool = True,
    interpret: bool = False,
) -> MixtureFields:
    """Fused 2D mixture evaluation; same contract as
    :func:`pigs_tpu.ops.oracle.eval_mixture_dense` (d=2 only, f32).

    Differentiable w.r.t. means/conics/values/samples via a custom VJP whose
    backward runs the fused kernels (Gaussian-side and sample-side
    reductions).  ``interpret=True`` runs the kernels through the Pallas
    interpreter (CPU tests).
    """
    if means.shape[1] != 2:
        raise ValueError("eval_mixture_pallas supports d=2 only")
    if mask is not None:
        # Fold the mask into the values: masked Gaussians contribute exactly
        # zero to every output and to every gradient.
        gate = mask.astype(values.dtype)[:, None]
        values = values * gate
    return _eval_core(means, conics, values, samples, order, period,
                      diff_samples, interpret)
