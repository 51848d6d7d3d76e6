"""Vectorized zero-run geometry (segment-aware).

Zero-run tokens group maximal runs of >= ZERO_RUN_MIN_LENGTH zero
residuals inside a partition (format.md:344-366). Run boundaries never
cross partition boundaries. This derives, fully in parallel:

* ``run_len``   — length of the maximal zero run containing each sample,
* ``long_run``  — sample is covered by a run token,
* ``run_start`` — sample is the first of a run token.

via prefix-max (last break before i) and suffix-min (next break after i).
"""

import numpy as np

from ..format import constants as C
from ._backend import cummax, cummin_reverse


def zero_breaks(z, xp=np):
    """Segment-independent break positions around zero runs.

    Returns (last_nz, next_nz): for each position, the index of the
    nearest non-zero sample at-or-before / at-or-after it (sentinels
    -L-2 / L+2 outside). Partition clamps are applied separately, so one
    pass serves every partition order. int32 throughout: half the bytes
    of a 64-bit scan.
    """
    L = z.shape[-1]
    idx = xp.arange(L, dtype=xp.int32)
    a = xp.where(~z, idx, xp.int32(-L - 2))
    b = xp.where(~z, idx, xp.int32(L + 2))
    last_nz = cummax(a, xp=xp)
    next_nz = cummin_reverse(b, xp=xp)
    return last_nz, next_nz


def run_geometry(z, last_nz, next_nz, pos_in_seg, seg_end_exclusive, xp=np):
    """Per-partition run geometry from precomputed breaks.

    Returns (run_len, long_run, run_start): length of the maximal zero
    run containing each sample (clamped to its partition), membership in
    a run token, and run-token start positions.
    """
    L = z.shape[-1]
    idx = xp.arange(L, dtype=xp.int32)
    seg_start = idx - xp.asarray(pos_in_seg).astype(xp.int32)
    run_first = xp.maximum(last_nz + xp.int32(1), seg_start)
    next_break = xp.minimum(next_nz, xp.asarray(seg_end_exclusive).astype(xp.int32))
    run_len = xp.where(z, next_break - run_first, xp.int32(0))
    long_run = z & (run_len >= C.ZERO_RUN_MIN_LENGTH)
    run_start = long_run & (idx == run_first)
    return run_len, long_run, run_start


def zero_run_info(z, pos_in_seg, seg_end_exclusive, xp=np):
    """Convenience wrapper: breaks + geometry in one call."""
    last_nz, next_nz = zero_breaks(z, xp=xp)
    return run_geometry(z, last_nz, next_nz, pos_in_seg, seg_end_exclusive, xp=xp)
