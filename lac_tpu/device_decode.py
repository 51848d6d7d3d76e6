"""Device-side batched decode: native tokenizer -> device reconstruction.

v3 block payloads are bit-serial, so tokenization runs in the native
runtime (parallel over independent blocks); everything after that is an
array program on device:

* fixed-predictor reconstruction inverts to repeated prefix sums
  (fully parallel across lanes and samples),
* FIR/LPC reconstruction is a vmapped lax.scan (the ``>> 15``/``>> 2``
  truncations are genuine recurrences),
* mid/side inversion and PCM range validation are elementwise.

This is the demonstration/alternate backend
(``FrameDecoder(backend="device")``); the pure-native path remains the
latency default for single files.
"""

import numpy as np

from .format import constants as C
from .ops import predictors
from .ops.stereo import ms_inverse


def _pow2(n):
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def _restore_groups(res_planes, block_sizes, sample_offsets, ptype, order, coeffs, xp):
    """Restore every (block, channel) lane on device in at most TWO
    batched calls: one masked-cumsum program for all fixed-predictor
    lanes (any order 0-4) and one vmapped scan for all FIR/LPC lanes
    (per-lane taps/shift). Lane gather/scatter is vectorized numpy; lane
    counts pad to powers of two so executable shapes stay stable across
    files. Returns int64 planes + ok flag."""
    channels = res_planes.shape[0]
    nb = len(block_sizes)
    out = res_planes.astype(np.int64).copy()

    bsz = np.asarray(block_sizes, np.int64)
    soff = np.asarray(sample_offsets, np.int64)
    lmax = int(bsz.max())
    # lane tables: lane = bi * channels + ch
    lane_b = np.repeat(np.arange(nb), channels)
    lane_c = np.tile(np.arange(channels), nb)
    lane_pt = np.asarray(ptype).reshape(-1)
    lane_od = np.asarray(order).reshape(-1).astype(np.int64)
    lane_sz = bsz[lane_b]
    # (lanes, lmax) gather with clipped indices; invalid tail reads lane start
    col = np.arange(lmax, dtype=np.int64)
    gidx = soff[lane_b][:, None] + np.minimum(col[None, :], lane_sz[:, None] - 1)
    batch_all = res_planes[lane_c[:, None], gidx].astype(np.int32)
    batch_all[col[None, :] >= lane_sz[:, None]] = 0

    restored = np.empty((nb * channels, lmax), dtype=np.int64)
    ok = True

    fixed = np.flatnonzero(lane_pt == C.PREDICTOR_FIXED)
    recur = np.flatnonzero(lane_pt != C.PREDICTOR_FIXED)
    if fixed.size:
        G = _pow2(fixed.size)
        fb = np.zeros((G, lmax), np.int32)
        fb[: fixed.size] = batch_all[fixed]
        fo = np.zeros(G, np.int64)
        fo[: fixed.size] = lane_od[fixed]
        fl = np.zeros(G, np.int64)
        fl[: fixed.size] = lane_sz[fixed]
        r, g_ok = predictors.fixed_restore_multi(
            xp.asarray(fb), xp.asarray(fo), valid_len=xp.asarray(fl), xp=xp
        )
        ok = ok and bool(np.asarray(g_ok)[: fixed.size].all())
        restored[fixed] = np.asarray(r)[: fixed.size]
    if ok and recur.size:
        G = _pow2(recur.size)
        rb = np.zeros((G, lmax), np.int32)
        rb[: recur.size] = batch_all[recur]
        is_fir = lane_pt[recur] == C.PREDICTOR_FIR
        cs = np.zeros((G, 33), np.int64)
        cs[: recur.size] = np.asarray(coeffs).reshape(nb * channels, -1)[recur]
        cs[: recur.size][is_fir] = 0
        cs[: recur.size, 1][is_fir] = C.FIR_TAPS[0]
        cs[: recur.size, 2][is_fir] = C.FIR_TAPS[1]
        ro = np.zeros(G, np.int64)
        ro[: recur.size] = np.where(is_fir, C.FIR_ORDER, lane_od[recur])
        sh = np.zeros(G, np.int64)
        sh[: recur.size] = np.where(is_fir, C.FIR_SHIFT, 15)
        mp = np.zeros(G, np.int64)
        mp[: recur.size] = np.where(is_fir, C.FIR_ORDER, 0)
        rl = np.zeros(G, np.int64)
        rl[: recur.size] = lane_sz[recur]
        r, g_ok = predictors.recurrence_restore(
            xp.asarray(rb), xp.asarray(cs), xp.asarray(ro), xp.asarray(sh),
            xp.asarray(mp), valid_len=xp.asarray(rl), xp=xp
        )
        ok = ok and bool(np.asarray(g_ok)[: recur.size].all())
        restored[recur] = np.asarray(r)[: recur.size]
    if not ok:
        return out, False

    # vectorized scatter back into the planes (valid region only)
    valid = col[None, :] < lane_sz[:, None]
    rows = np.broadcast_to(lane_c[:, None], gidx.shape)
    out[rows[valid], gidx[valid]] = restored[valid]
    return out, ok


def decode_v3_device(hdr, block_sizes, payload_sizes, block_payload, total_samples, thread_count=0, xp=None):
    """Device-batched v3 decode. Returns (left, right) int32 arrays or
    raises ValueError (bad block index in the message)."""
    if xp is None:
        from . import configure_jax

        configure_jax()
        import jax.numpy as jnp

        xp = jnp
    from .runtime.native import tokenize_v3_blocks_native

    payload_offsets = np.concatenate([[0], np.cumsum(payload_sizes)])[:-1]
    sample_offsets = np.concatenate([[0], np.cumsum(block_sizes)])[:-1]
    tok = tokenize_v3_blocks_native(
        block_payload, payload_offsets, payload_sizes, block_sizes, sample_offsets,
        hdr.channels, hdr.stereo_mode, total_samples, thread_count,
    )
    if tok is None:
        raise RuntimeError("native runtime unavailable for device decode")
    res, ptype, order, coeffs, msflag = tok

    planes, ok = _restore_groups(res, block_sizes, sample_offsets, ptype, order, coeffs, xp)
    if not ok:
        raise ValueError("reconstruction outside int32 range")

    lo, hi = C.pcm_range(hdr.bit_depth)
    left = planes[0]
    if hdr.channels == 2:
        right = planes[1]
        # per-sample ms flag from per-block flags
        ms_mask = np.repeat(msflag.astype(bool), block_sizes)
        l_ms, r_ms = ms_inverse(left, right)
        l_ms, r_ms = np.asarray(l_ms), np.asarray(r_ms)
        left = np.where(ms_mask, l_ms, left)
        right = np.where(ms_mask, r_ms, right)
        if (left.min(initial=0) < lo or left.max(initial=0) > hi or
                right.min(initial=0) < lo or right.max(initial=0) > hi):
            raise ValueError("decoded sample outside PCM bit depth")
        return left.astype(np.int32), right.astype(np.int32)
    if left.min(initial=0) < lo or left.max(initial=0) > hi:
        raise ValueError("decoded sample outside PCM bit depth")
    return left.astype(np.int32), np.empty(0, np.int32)
