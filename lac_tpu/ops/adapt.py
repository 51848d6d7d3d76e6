"""Closed-form Rice k-adaptation sequences.

The reference adapts ``k`` serially after every residual sample
(rice.hpp:45-114 stateful; block/encoder.cpp:72-77 stateless). The key
array-program observation: the adaptation state is a pure function of the
*history of unsigned residuals* — there is no feedback from ``k`` into
the state. Concretely, for sample index ``i`` (0-based) of a segment:

* ``sum_i``/``count_i`` are prefix sums,
* the 256-entry drift window holds exactly the last 256 ``u`` values, so
  ``window_sum_i = sum_i - sum_{i-256}`` (sliding-window sum),
* the 96-entry micro window's large/zero counters are sliding-window
  sums of per-sample flags derived from ``u_i`` and the mean-based k,
* the micro trigger ``window_index+1 >= 96 || window_filled >= 96``
  reduces to ``count_i >= 96``.

Hence the whole k-sequence is cumsum + elementwise ops — embarrassingly
parallel across samples, partitions, candidates, and blocks. This module
computes ``k_used[i]`` — the k that encodes sample ``i`` (``initial_k``
for the first sample, then the adapted value).
"""

import numpy as np

from ..format import constants as C
from ._backend import bit_width, is_jax, shift_right


def _k_base_divfree(N, c, bwc, xp):
    """``min(31, bit_width(mean - 1))`` for ``mean = floor(N/c) >= 2``
    WITHOUT computing the mean (no integer or float division on the
    whole (..., L) operand).

    ``bit_width(mean-1) <= t  <=>  mean <= 2^t  <=>  N < c*(2^t + 1)
    <=> (N - c) >> t < c``.  With ``M = N - c``, ``b1 = bit_width(M)``
    and ``b2 = bit_width(c)``: ``c*2^(b1-b2+1) >= 2^b1 > M`` and
    ``c*2^(b1-b2-1) < 2^(b1-1) <= M``, so the smallest such ``t`` is
    ``k0 = b1 - b2`` or ``k0 + 1``, resolved by one comparison.

    Callers gate the ``mean <= 1`` region (``N < 2c``) to 0 themselves;
    there ``M`` is clamped to 1 and the result is discarded.

    ``bwc``: precomputed ``bit_width(c)`` (baked constant when ``c`` is
    a static position vector).
    """
    M = xp.maximum(N.astype(xp.int64) - c.astype(xp.int64), xp.int64(1)).astype(xp.uint64)
    k0 = xp.maximum(bit_width(M, xp=xp) - bwc, xp.int32(0))
    q0 = M >> k0.astype(xp.uint64)
    return xp.minimum(xp.int32(C.MAX_RICE_K), k0 + (q0 >= c).astype(xp.int32))


def _floordiv3(x, xp):
    """Exact ``floor(x/3)`` for uint64 ``x < 2^35``, division-free.

    ``x = xh*2^16 + xl`` and ``2^16 = 3*21845 + 1`` give ``floor(x/3) =
    xh*21845 + floor((xh+xl)/3)``; the inner ``y = xh+xl`` is ``< 2^20``
    and ``(y*699051) >> 21`` is exact there (``699051 = (2^21+1)/3``, so
    the estimate exceeds ``y/3`` by ``y/(3*2^21) < 1/6``, which never
    crosses a floor boundary since ``frac(y/3) <= 2/3``).
    """
    xh = x >> xp.uint64(16)
    y = xh + (x & xp.uint64(0xFFFF))
    return xh * xp.uint64(21845) + ((y * xp.uint64(699051)) >> xp.uint64(21))


def k_after_stateless(seg_sum, pos_in_seg, xp=np):
    """Stateless adapted k after each sample (block/encoder.cpp:72-77),
    division-free (see :func:`_k_base_divfree`).

    ``seg_sum``: segment-local inclusive prefix sum of u (uint64).
    ``pos_in_seg``: 0-based position within the segment (int64; may be a
    baked numpy constant for static partition geometry).
    """
    if isinstance(pos_in_seg, np.ndarray) or isinstance(pos_in_seg, int):
        count_np = np.asarray(pos_in_seg, dtype=np.int64).astype(np.uint64) + np.uint64(1)
        count = xp.asarray(count_np)
        bwc = xp.asarray(bit_width(count_np, xp=np))
    else:
        count = (pos_in_seg + 1).astype(xp.uint64)
        bwc = bit_width(count, xp=xp)
    N = seg_sum.astype(xp.uint64) + (count >> xp.uint64(1))
    k = _k_base_divfree(N, count, bwc, xp)
    return xp.where(N < (count << xp.uint64(1)), xp.int32(0), k)


def k_after_stateful(u, xp=np):
    """Stateful adapted k after each sample of a whole block (rice.hpp:45-114).

    ``u``: (..., L) uint64 unsigned residuals. Returns int32 (..., L).
    """
    one = xp.uint64(1)
    L = u.shape[-1]
    # prefix sums via 16-bit-split u32 cumsums (a u64 cumsum moves twice
    # the bytes); the u64 reconstruction is one elementwise op. On the
    # GPU both scans run in one Triton pass (pallas_kernels) — exact.
    u32v = u.astype(xp.uint32)
    use_pk = False
    if is_jax(xp):
        from . import pallas_kernels as _pk

        use_pk = _pk.kernel_applicable(L)
    if use_pk:
        cs_hi, cs_lo = _pk.split_cumsums_u32(u32v)
    else:
        cs_hi = xp.cumsum(u32v >> xp.uint32(16), axis=-1)
        cs_lo = xp.cumsum(u32v & xp.uint32(0xFFFF), axis=-1)
    s = (cs_hi.astype(xp.uint64) << xp.uint64(16)) + cs_lo.astype(xp.uint64)
    idx = xp.arange(L, dtype=xp.int64)
    count = (idx + 1).astype(xp.uint64)
    bwc_np = bit_width((np.arange(L, dtype=np.int64) + 1).astype(np.uint64), xp=np)
    bwc = xp.asarray(bwc_np)  # baked constant: bit_width(count)

    N = s + (count >> one)
    k_base = xp.where(
        N < (count << one),  # mean <= 1
        xp.int32(0),
        _k_base_divfree(N, count, bwc, xp),
    )

    # drift-window bias, division-free. Two regimes:
    #  - count <= 256: the window holds the whole prefix with the same
    #    rounding, so local_mean == mean and both ratio tests are
    #    identically false -> drift bias 0.
    #  - count > 256: filled == 256, lm = (window_sum + 128) >> 8, and
    #    the two floored-mean comparisons flip into threshold tests on N:
    #      3*lm > 4*mean   <=>  mean <= (3*lm - 1) >> 2  (lm >= 1)
    #                      <=>  N < c * (((3*lm - 1) >> 2) + 1)
    #      4*lm+3 < 3*mean <=>  mean >= floor((4*lm + 3)/3) + 1
    #                      <=>  N >= c * (floor((4*lm + 3)/3) + 1)
    window_sum = s - shift_right(s, C.DRIFT_WINDOW, xp=xp)
    lm = (window_sum + xp.uint64(C.DRIFT_WINDOW >> 1)) >> xp.uint64(8)
    t1 = ((xp.uint64(3) * lm - one) >> xp.uint64(2)) + one  # wraps at lm=0; gated below
    cond_up = (lm >= one) & (N < count * t1)
    t2 = _floordiv3(xp.uint64(4) * lm + xp.uint64(3), xp) + one
    cond_down = N >= count * t2
    drift_on = (idx >= xp.int64(C.DRIFT_WINDOW)) & (N >= count)  # full window & mean > 0
    bias = xp.where(
        drift_on & cond_up,
        xp.int32(1),
        xp.where(drift_on & ~cond_up & cond_down, xp.int32(-1), xp.int32(0)),
    )

    # micro window: quotient-distribution counters over the last 96
    # samples. Both flag cumsums ride ONE u32 scan: counts are <= L <=
    # 16384 < 2^16, so is_large packs in the low half and is_zero in the
    # high half with no carry between them.
    # native u32 shift (u < 2^32; only the >3 / ==0 flags are consumed)
    q_base = xp.where(
        k_base >= xp.int32(C.MAX_RICE_K), xp.uint32(0), u32v >> k_base.astype(xp.uint32)
    )
    packed = (q_base > xp.uint32(3)).astype(xp.uint32) + ((q_base == xp.uint32(0)).astype(xp.uint32) << xp.uint32(16))
    if use_pk:
        cp = _pk.cumsum_u32(packed)
    else:
        cp = xp.cumsum(packed, axis=-1)
    wp = cp - shift_right(cp, C.MICRO_WINDOW, xp=xp)
    large_cnt = (wp & xp.uint32(0xFFFF)).astype(xp.int32)
    zero_cnt = (wp >> xp.uint32(16)).astype(xp.int32)
    trigger = count >= xp.uint64(C.MICRO_WINDOW)
    wsize = xp.minimum(idx + 1, xp.int64(C.MICRO_WINDOW)).astype(xp.int32)
    cond_large = large_cnt * 4 >= wsize * 3
    cond_zero = zero_cnt * 5 >= wsize * 4
    bias = xp.where(
        trigger & cond_large,
        xp.minimum(bias + xp.int32(1), xp.int32(1)),
        xp.where(trigger & ~cond_large & cond_zero, xp.maximum(bias - xp.int32(1), xp.int32(-1)), bias),
    )

    return xp.clip(k_base + bias, 0, C.MAX_RICE_K).astype(xp.int32)


def k_used_from_after(k_after, initial_k, xp=np):
    """Shift the post-sample k sequence into the pre-sample (encoding) k.

    ``initial_k`` may be scalar or broadcastable to the leading shape.
    """
    shifted = shift_right(k_after, 1, xp=xp)
    L = k_after.shape[-1]
    first = xp.arange(L, dtype=xp.int64) == 0
    init = xp.asarray(initial_k, dtype=xp.int32)
    if getattr(init, "ndim", 0) > 0:
        init = init[..., None]
    return xp.where(first, init, shifted).astype(xp.int32)


def k_used_stateless_from_cumsum(s_incl, pos_in_seg, initial_k_per_sample, xp=np):
    """Per-sample encoding k for stateless (partitioned) adaptation, from
    a precomputed inclusive global cumsum of u (reused across partition
    orders during the sweep).
    """
    # segment-local prefix sums: subtract the global cumsum just before
    # each segment start (gathered via i - pos_in_seg).
    idx = xp.arange(s_incl.shape[-1], dtype=xp.int64)
    seg_start = idx - pos_in_seg
    s_shift = shift_right(s_incl, 1, xp=xp)  # exclusive global cumsum
    base = xp.take_along_axis(
        s_shift, xp.broadcast_to(seg_start, s_incl.shape).astype(xp.int64), axis=-1
    ) if s_incl.ndim > 1 else s_shift[seg_start]
    seg_sum = s_incl - base
    k_after = k_after_stateless(seg_sum, pos_in_seg, xp=xp)
    shifted = shift_right(k_after, 1, xp=xp)
    return xp.where(pos_in_seg == 0, initial_k_per_sample, shifted).astype(xp.int32)


def k_used_stateless_segmented(u, pos_in_seg, initial_k_per_sample, xp=np):
    """Per-sample encoding k for stateless (partitioned) adaptation.

    ``u``: (..., L) uint64; ``pos_in_seg``: (..., L) int64 position within
    each sample's partition; ``initial_k_per_sample``: int32 per-sample
    initial k (the owning partition's initial_k, used at pos 0).
    """
    s = xp.cumsum(u.astype(xp.uint64), axis=-1)
    return k_used_stateless_from_cumsum(s, pos_in_seg, initial_k_per_sample, xp=xp)
