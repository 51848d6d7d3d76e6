"""Exact bit-cost models for residual mode selection (segment-aware).

This module is the *readable specification* of the cost machinery: the
production planner (encoder.plan_group) inlines equivalent math with
device-oriented layouts (16-bit-split u32 cumsums, static-geometry boundary
gathers); tests/test_costs_spec.py pins the two against each other.

Reproduces the reference's estimators bit-for-bit
(block/encoder.cpp:121-263) as parallel reductions:

* ``initial_k``  — best k in [0,12] over the first 256 samples,
* ``static_k``   — best fixed k in [0,15] over the whole segment,
* ``mode_costs`` — exact simulated rice / zero-run / bin bit counts,
  sharing one adapted k-sequence (the adaptation input is identical in
  every mode: each logical sample contributes its unsigned value).

All are computed per segment via segment sums, so the same code scores
whole blocks (1 segment) and partition sweeps (2^p segments).
"""

import numpy as np

from ..format import constants as C
from ._backend import segment_sum


def rice_cost_per_sample(u, k, xp=np):
    """Bits for one Rice token: q + 1 + k, with q forced 0 at k>=31
    (block/encoder.cpp:67-70)."""
    q = xp.where(k >= xp.int32(C.MAX_RICE_K), xp.uint64(0), u >> xp.asarray(k).astype(xp.uint64))
    return q + xp.uint64(1) + xp.asarray(k).astype(xp.uint64)


def _best_k_by_cost(u, weight_mask, seg_id, num_segments, k_max, xp=np):
    """argmin_k segsum(rice cost at k) for k in [0, k_max]; lowest k wins ties.

    Returns (best_k int32 (..., S), best_bits uint64 (..., S)).
    """
    costs = []
    masked_u = u
    w = weight_mask.astype(xp.uint64)
    for k in range(k_max + 1):
        per = (masked_u >> xp.uint64(k)) + xp.uint64(1 + k)
        costs.append(segment_sum(per * w, seg_id, num_segments, xp=xp))
    stack = xp.stack(costs, axis=-1)  # (..., S, k_max+1)
    best_k = xp.argmin(stack, axis=-1).astype(xp.int32)
    best_bits = xp.min(stack, axis=-1)
    return best_k, best_bits


def initial_k(u, pos_in_seg, valid, seg_id, num_segments, xp=np):
    """Per-segment initial k (block/encoder.cpp:121-158): scan the first
    min(256, len) samples, k in [0, 12], pick the cheapest (lowest tie)."""
    mask = valid & (pos_in_seg < C.INITIAL_SCAN_COUNT)
    k, _ = _best_k_by_cost(u, mask, seg_id, num_segments, C.INITIAL_MAX_K, xp=xp)
    return k


def static_k_and_bits(u, valid, seg_id, num_segments, xp=np):
    """Per-segment static-Rice k in [0, 15] and its exact total bits
    (block/encoder.cpp:160-188)."""
    return _best_k_by_cost(u, valid, seg_id, num_segments, C.MAX_STATIC_K, xp=xp)


def mode_costs(v, u, k_used, valid, run_len, long_run, run_start, seg_id, num_segments, xp=np):
    """Exact per-segment bit costs of the three adaptive modes
    (block/encoder.cpp:201-263).

    Returns dict with ``rice``, ``zr``, ``bin`` (uint64 (..., S)) and
    ``has_run`` (bool (..., S)).
    """
    w = valid.astype(xp.uint64)
    rice_per = rice_cost_per_sample(u, k_used, xp=xp)
    rice_bits = segment_sum(rice_per * w, seg_id, num_segments, xp=xp)

    # bin mode: 2 bits for 0, 3 for +-1/+-2, tag+rice otherwise
    absv = xp.abs(v.astype(xp.int64))
    bin_per = xp.where(
        absv == 0,
        xp.uint64(2),
        xp.where(absv <= 2, xp.uint64(3), xp.uint64(2) + rice_per),
    )
    bin_bits = segment_sum(bin_per * w, seg_id, num_segments, xp=xp)

    # zero-run mode: run tokens pay 2 + rice(run-4, k=2); other samples
    # pay 2 + (escape ? 32 : rice) — samples inside long runs pay nothing.
    esc_shift = xp.minimum(k_used + C.ESCAPE_K_OFFSET, xp.int32(C.ESCAPE_K_CAP))
    esc_thresh = xp.uint64(1) << esc_shift.astype(xp.uint64)
    token_per = xp.uint64(2) + xp.where(u > esc_thresh, xp.uint64(32), rice_per)
    run_per = xp.uint64(2) + (
        (run_len - C.ZERO_RUN_MIN_LENGTH).astype(xp.uint64) >> xp.uint64(C.ZERO_RUN_LENGTH_K)
    ) + xp.uint64(1 + C.ZERO_RUN_LENGTH_K)
    zr_per = xp.where(run_start, run_per, xp.where(long_run, xp.uint64(0), token_per))
    zr_bits = segment_sum(zr_per * w, seg_id, num_segments, xp=xp)

    has_run = segment_sum(run_start.astype(xp.int64) * valid.astype(xp.int64), seg_id, num_segments, xp=xp) > 0
    return {"rice": rice_bits, "zr": zr_bits, "bin": bin_bits, "has_run": has_run}
