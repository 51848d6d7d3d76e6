"""Backend-parameterized array helpers.

Every op in :mod:`lac_tpu.ops` takes an ``xp`` module argument (numpy by
default, ``jax.numpy`` when traced/jitted) so a single source of truth
serves both the host path and the device path. This module collects the few
primitives whose spelling differs between the two.
"""

import numpy as np


def is_jax(xp) -> bool:
    return xp.__name__.startswith("jax")


def cummax(x, xp=np, axis=-1):
    if is_jax(xp):
        import jax

        return jax.lax.cummax(x, axis=axis if axis >= 0 else x.ndim + axis)
    return np.maximum.accumulate(x, axis=axis)


def cummin_reverse(x, xp=np, axis=-1):
    """Running minimum from the right (suffix min)."""
    if is_jax(xp):
        import jax

        return jax.lax.cummin(x, axis=axis if axis >= 0 else x.ndim + axis, reverse=True)
    return np.flip(np.minimum.accumulate(np.flip(x, axis=axis), axis=axis), axis=axis)


def exclusive_cumsum(x, xp=np, axis=-1):
    c = xp.cumsum(x, axis=axis)
    return c - x


def shift_right(x, n, xp=np, fill=0, axis=-1):
    """Shift along axis by n towards higher indices, filling with ``fill``."""
    if n == 0:
        return x
    pad_width = [(0, 0)] * x.ndim
    ax = axis if axis >= 0 else x.ndim + axis
    pad_width[ax] = (n, 0)
    padded = xp.pad(x, pad_width, constant_values=fill)
    idx = [slice(None)] * x.ndim
    idx[ax] = slice(0, x.shape[ax])
    return padded[tuple(idx)]


def bit_width(m, xp=np, max_bits=33):
    """``std::bit_width`` for unsigned values: position of highest set bit.

    ``bit_width(0) == 0``. Computed from the float64 exponent field —
    exact for m < 2^53 (uint64 -> f64 conversion is exact there, and the
    biased exponent is floor(log2 m) + 1023). Every call site feeds
    means/values < 2^47. Three elementwise ops instead of a 33-compare
    unroll.
    """
    m = m.astype(xp.uint64)
    if is_jax(xp):
        import jax

        # 32-bit clz halves: Clz on u32 is a native XLA op on every
        # backend (no 64-bit bitcast/frexp needed).
        hi = (m >> xp.uint64(32)).astype(xp.uint32)
        lo = m.astype(xp.uint32)
        bw_hi = xp.int32(64) - jax.lax.clz(hi).astype(xp.int32)
        bw_lo = xp.int32(32) - jax.lax.clz(lo).astype(xp.int32)
        return xp.where(hi != 0, bw_hi, xp.where(lo != 0, bw_lo, xp.int32(0)))
    # frexp: f = mant * 2^e with mant in [0.5, 1) -> e == bit_width(m)
    # exactly for exactly-converted integers (all call sites are < 2^53).
    _, e = np.frexp(m.astype(np.float64))
    return np.where(m == 0, 0, e).astype(np.int32)


def segment_sum(values, seg_id, num_segments, xp=np, axis=-1):
    """Sum ``values`` per segment id along the last axis.

    ``seg_id`` has the same shape as values; ids in [0, num_segments).
    Returns (..., num_segments).
    """
    if is_jax(xp):
        import jax

        f = lambda v, s: jax.ops.segment_sum(v, s, num_segments=num_segments)
        for _ in range(values.ndim - 1):
            f = jax.vmap(f)
        return f(values, seg_id)
    lead = values.shape[:-1]
    out = np.zeros(lead + (num_segments,), dtype=values.dtype)
    flat_vals = values.reshape(-1, values.shape[-1])
    flat_ids = np.broadcast_to(seg_id, values.shape).reshape(-1, values.shape[-1])
    flat_out = out.reshape(-1, num_segments)
    rows = np.repeat(np.arange(flat_vals.shape[0]), values.shape[-1])
    np.add.at(flat_out, (rows, flat_ids.ravel()), flat_vals.ravel())
    return out
