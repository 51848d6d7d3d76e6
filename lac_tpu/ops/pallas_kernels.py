"""Row prefix-sum kernels for the GPU (Pallas through Triton).

``adapt.k_after_stateful`` needs inclusive prefix sums of u32 codes
along the 16384-sample axis of every candidate lane: the 16-bit-split
pair ``cumsum(u >> 16), cumsum(u & 0xFFFF)`` and the packed flag
counters. XLA lowers ``cumsum`` on the GPU as a reduce-window tree scan;
these kernels read each row once and write each scan once instead,
with the hi/lo split fused into the same pass.

One program scans one row: a ``fori_loop`` over column tiles carries
the running sum in registers (programs run in no order, so nothing may
carry between them), and the rows spread over the SMs.

Exactness: every sum is of 16-bit halves or flag counts over at most
16384 samples (< 2^30), so int32 lanes hold it and the association of
the adds does not matter. Shapes the kernels do not cover take XLA's
``cumsum`` (:func:`split_cumsums_u32`, :func:`cumsum_u32`).
"""

import functools

import numpy as np

_TILE = 2048  # columns per loop step: 8 KB of int32 per operand


def kernel_applicable(n):
    """True when the Triton scans run for rows of length ``n``: on the
    GPU backend, for whole multiples of the column tile."""
    import jax

    return n % _TILE == 0 and jax.default_backend() == "gpu"


def _scan_kernel(u_ref, *out_refs, split):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    n = u_ref.shape[0]

    def body(j, carry):
        sl = pl.ds(pl.multiple_of(j * _TILE, _TILE), _TILE)
        u = u_ref[sl]
        if split:
            parts = ((u >> 16) & 0xFFFF, u & 0xFFFF)
        else:
            parts = (u,)
        new = []
        for ref, x, c in zip(out_refs, parts, carry):
            ref[sl] = jax.lax.cumsum(x, axis=0) + c
            new.append(c + jnp.sum(x, dtype=jnp.int32))
        return tuple(new)

    zero = jnp.int32(0)
    jax.lax.fori_loop(zero, jnp.int32(n // _TILE), body, (zero,) * len(out_refs))


@functools.lru_cache(maxsize=32)
def _build(rows, n, split, interpret):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    nout = 2 if split else 1
    spec = pl.BlockSpec((None, n), lambda i: (i, 0))
    return pl.pallas_call(
        functools.partial(_scan_kernel, split=split),
        grid=(rows,),
        in_specs=[spec],
        out_specs=[spec] * nout,
        out_shape=[jax.ShapeDtypeStruct((rows, n), jnp.int32)] * nout,
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="split_cumsum" if split else "cumsum",
    )


def _rows(x):
    lead = x.shape[:-1]
    return int(np.prod(lead)) if lead else 1


def split_cumsums_u32(u32, interpret=False):
    """(..., n) uint32 -> (cumsum(u >> 16), cumsum(u & 0xFFFF)) along the
    last axis, both uint32. Requires ``n % 2048 == 0``."""
    import jax

    shape = u32.shape
    as_i32 = jax.lax.bitcast_convert_type(u32, "int32").reshape(_rows(u32), shape[-1])
    hi, lo = _build(as_i32.shape[0], shape[-1], True, interpret)(as_i32)
    cvt = lambda a: jax.lax.bitcast_convert_type(a, "uint32").reshape(shape)
    return cvt(hi), cvt(lo)


def cumsum_u32(u32, interpret=False):
    """(..., n) uint32 inclusive prefix sum along the last axis, for
    sums below 2^31. Requires ``n % 2048 == 0``."""
    import jax

    shape = u32.shape
    as_i32 = jax.lax.bitcast_convert_type(u32, "int32").reshape(_rows(u32), shape[-1])
    (out,) = _build(as_i32.shape[0], shape[-1], False, interpret)(as_i32)
    return jax.lax.bitcast_convert_type(out, "uint32").reshape(shape)
