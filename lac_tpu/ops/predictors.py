"""Predictor residual computation and reconstruction.

Encode side (open-loop, fully parallel stencils — the reference computes
these serially per sample, block/encoder.cpp:265-309, lpc.cpp:188-229):

* fixed orders 0-4: binomial differencing with raw warmup samples,
* FIR: taps {3,-1}, shift 2, order 2,
* LPC: Q15 integer dot over up to ``order`` preceding *original* samples
  (open loop), taps before block start omitted (zero-fill shifts).

Decode side (closed-loop):

* fixed orders invert to repeated prefix sums after mapping the raw
  warmup samples into the zero-extended difference domain — fully
  parallel (the reference restores serially, block/decoder.cpp:308-342),
* FIR/LPC restores are true recurrences (the ``>> 15`` truncation breaks
  superposition): lax.scan on device / native loop on host.
"""

import numpy as np

from ..format import constants as C
from ._backend import is_jax, shift_right

# Pascal-triangle stencil weights for fixed predictors: residual[n] =
# sum_i w[i] * x[n-i] (format.md:152-160 rearranged to difference form).
_FIXED_STENCILS = {
    0: (1,),
    1: (1, -1),
    2: (1, -2, 1),
    3: (1, -3, 3, -1),
    4: (1, -4, 6, -4, 1),
}


def fixed_residual(x, order, xp=np):
    """Fixed-order residual; first ``order`` samples are raw (int32 in/out)."""
    x64 = x.astype(xp.int64)
    acc = xp.zeros_like(x64)
    for i, w in enumerate(_FIXED_STENCILS[order]):
        acc = acc + xp.int64(w) * shift_right(x64, i, xp=xp)
    idx = xp.arange(x.shape[-1], dtype=xp.int64)
    return xp.where(idx < order, x64, acc).astype(xp.int32)


def fir_residual(x, xp=np):
    """FIR taps {3,-1} >> 2 residual; first 2 samples raw."""
    x64 = x.astype(xp.int64)
    pred = (xp.int64(C.FIR_TAPS[0]) * shift_right(x64, 1, xp=xp)
            + xp.int64(C.FIR_TAPS[1]) * shift_right(x64, 2, xp=xp)) >> xp.int64(C.FIR_SHIFT)
    idx = xp.arange(x.shape[-1], dtype=xp.int64)
    return xp.where(idx < C.FIR_ORDER, x64, x64 - pred).astype(xp.int32)


def lpc_residual(x, coeffs_q15, order, xp=np):
    """Open-loop LPC residual (lpc.cpp:38-61).

    ``coeffs_q15``: (..., order+1) int16-valued, index 0 unused.
    Returns (residual int32, in_range bool) — ``in_range`` is False when
    any open-loop difference leaves the int32 domain (the caller then
    walks the fallback order ladder, lpc.cpp:188-229).
    """
    x64 = x.astype(xp.int64)
    acc = xp.zeros_like(x64)
    for i in range(1, order + 1):
        ci = coeffs_q15[..., i].astype(xp.int64)
        if getattr(ci, "ndim", 0) > 0:
            ci = ci[..., None]
        acc = acc + ci * shift_right(x64, i, xp=xp)
    pred = acc >> xp.int64(15)
    diff = x64 - pred
    in_range = xp.all((diff >= C.INT32_MIN) & (diff <= C.INT32_MAX), axis=-1)
    return diff.astype(xp.int32), in_range


def lpc_ladder_order(x, coeffs_q15, start_order, max_order):
    """Walk the residual-overflow fallback ladder for one lane (numpy).

    Mirrors the reference ``compute_residual_q15`` attempt sequence
    (lpc.cpp:188-229 via build_residual_attempt_orders, lpc.cpp:24-36):
    try ``start_order``, then each ladder order below it, then 0.
    Returns the first order whose open-loop residual stays in int32
    (0 means the verbatim copy — the encoder then skips the candidate,
    block/encoder.cpp:401-403).

    Zeroing ``coeffs_q15[o+1:]`` afterwards makes a full-order residual
    computation produce exactly the ``o``-tap residual, because warmup
    taps already clamp to ``min(order, n)`` — so callers can reuse the
    batched residual path with truncated coefficient sets.
    """
    start_order = max(0, min(int(start_order), int(max_order)))
    attempts = [start_order]
    attempts += [o for o in C.LPC_FALLBACK_ORDERS if o < start_order and o <= max_order]
    attempts.append(0)
    x64 = np.asarray(x, dtype=np.int64)
    for o in attempts:
        if o <= 0:
            return 0
        acc = np.zeros_like(x64)
        for i in range(1, o + 1):
            acc[i:] += int(coeffs_q15[i]) * x64[:-i]
        diff = x64 - (acc >> 15)
        if diff.size == 0 or (diff.min() >= C.INT32_MIN and diff.max() <= C.INT32_MAX):
            return o
    return 0


# --------------------------------------------------------------------- decode

# bound on any intermediate difference order of an int32-valued sequence:
# |delta^m x| <= 2^(31+m) <= 2^36 for m <= 5; beyond it the final samples
# cannot all fit int32, so the reference would reject too.
_STAGE_BOUND = 1 << 37


def fixed_restore(res, order, valid_len=None, xp=np):
    """Invert a fixed-order predictor via repeated prefix sums.

    ``res``: (..., L) int32 residuals (warmup entries raw). Returns
    (samples int64, ok bool (...,)) — ``ok`` False when reconstruction
    leaves the int32 domain anywhere in the valid region (the reference
    rejects on the first out-of-range step, block/decoder.cpp:308-342;
    acceptance is equivalent).
    """
    y = res.astype(xp.int64)
    L = y.shape[-1]
    idx = xp.arange(L, dtype=xp.int64)
    vmask = idx < (xp.int64(L) if valid_len is None else xp.asarray(valid_len)[..., None] if getattr(valid_len, "ndim", 0) else xp.int64(valid_len))
    if order == 0:
        ok = xp.all(xp.where(vmask, (y >= C.INT32_MIN) & (y <= C.INT32_MAX), True), axis=-1)
        return y, ok

    # map raw warmup samples into the zero-extended difference domain:
    # warm'[n] = sum_i w[i] * x[n-i] over available taps (n < order)
    w = _FIXED_STENCILS[order]
    warm = xp.zeros_like(y)
    for i, wi in enumerate(w):
        warm = warm + xp.int64(wi) * shift_right(y, i, xp=xp)
    y = xp.where(idx < order, warm, y)

    ok = xp.ones(y.shape[:-1], dtype=bool)
    for _ in range(order):
        y = xp.cumsum(xp.where(vmask, y, 0), axis=-1)
        ok = ok & xp.all(xp.where(vmask, xp.abs(y) <= _STAGE_BOUND, True), axis=-1)
    ok = ok & xp.all(xp.where(vmask, (y >= C.INT32_MIN) & (y <= C.INT32_MAX), True), axis=-1)
    return y, ok


def fir_restore(res, valid_len=None, xp=np):
    """Closed-loop FIR reconstruction (block/decoder.cpp:344-358)."""
    if is_jax(xp):
        return _fir_restore_jax(res, valid_len)
    res = np.asarray(res)
    y = res.astype(np.int64).copy()
    L = y.shape[-1]
    n_valid = L if valid_len is None else valid_len
    flat = y.reshape(-1, L)
    ok = np.ones(flat.shape[0], dtype=bool)
    for row in range(flat.shape[0]):
        r = flat[row]
        nv = int(n_valid if np.ndim(n_valid) == 0 else np.asarray(n_valid).reshape(-1)[row])
        for n in range(C.FIR_ORDER, nv):
            pred = (3 * r[n - 1] - r[n - 2]) >> 2
            s = r[n] + pred
            if s < C.INT32_MIN or s > C.INT32_MAX:
                ok[row] = False
                break
            r[n] = s
    return y, ok.reshape(res.shape[:-1])


def lpc_restore(res, coeffs_q15, order, valid_len=None, xp=np):
    """Closed-loop LPC reconstruction (block/decoder.cpp:360-403)."""
    if is_jax(xp):
        return _lpc_restore_jax(res, coeffs_q15, order, valid_len)
    res = np.asarray(res)
    y = res.astype(np.int64).copy()
    L = y.shape[-1]
    flat = y.reshape(-1, L)
    cflat = np.asarray(coeffs_q15, dtype=np.int64).reshape(-1, np.asarray(coeffs_q15).shape[-1])
    if cflat.shape[0] == 1 and flat.shape[0] > 1:
        cflat = np.broadcast_to(cflat, (flat.shape[0], cflat.shape[1]))
    n_valid = L if valid_len is None else valid_len
    ok = np.ones(flat.shape[0], dtype=bool)
    for row in range(flat.shape[0]):
        r = flat[row]
        c = cflat[row]
        nv = int(n_valid if np.ndim(n_valid) == 0 else np.asarray(n_valid).reshape(-1)[row])
        for n in range(nv):
            taps = min(order, n)
            acc = 0
            for i in range(1, taps + 1):
                acc += int(c[i]) * int(r[n - i])
            s = int(r[n]) + (acc >> 15)
            if s < C.INT32_MIN or s > C.INT32_MAX:
                ok[row] = False
                break
            r[n] = s
    return y, ok.reshape(res.shape[:-1])


def fixed_restore_multi(res, order, valid_len=None, xp=np):
    """Fixed-order reconstruction with a *per-lane* order vector.

    One array program restores every fixed-predictor lane regardless of
    its order (0..4): the warmup mapping gathers the per-lane stencil
    row, then four masked cumsum rounds apply ``order[l]`` prefix sums
    to lane ``l``. Semantics identical to per-order :func:`fixed_restore`
    (block/decoder.cpp:308-342 acceptance).

    ``res``: (G, L) residuals; ``order``: (G,) ints. Returns
    (samples int64 (G, L), ok bool (G,)).
    """
    y = xp.asarray(res).astype(xp.int64)
    G, L = y.shape
    od = xp.asarray(order).astype(xp.int64)
    idx = xp.arange(L, dtype=xp.int64)
    nv = (xp.full((G,), L, dtype=xp.int64) if valid_len is None
          else xp.asarray(valid_len).astype(xp.int64))
    vmask = idx[None, :] < nv[:, None]

    # stencil table rows indexed by per-lane order (zero-padded)
    table = np.zeros((5, 5), dtype=np.int64)
    for o, w in _FIXED_STENCILS.items():
        table[o, : len(w)] = w
    table = xp.asarray(table)
    w_lane = table[od]  # (G, 5)
    warm = xp.zeros_like(y)
    for i in range(5):
        warm = warm + w_lane[:, i : i + 1] * shift_right(y, i, xp=xp)
    y = xp.where(idx[None, :] < od[:, None], warm, y)

    ok = xp.ones((G,), dtype=bool)
    for r in range(4):
        active = od > r  # (G,)
        c = xp.cumsum(xp.where(vmask, y, 0), axis=-1)
        y = xp.where(active[:, None], c, y)
        ok = ok & (xp.all(xp.where(vmask, xp.abs(y) <= _STAGE_BOUND, True), axis=-1) | ~active)
    ok = ok & xp.all(xp.where(vmask, (y >= C.INT32_MIN) & (y <= C.INT32_MAX), True), axis=-1)
    return y, ok


def recurrence_restore(res, coeffs, order, shift, min_pred_n, valid_len=None, xp=np):
    """Closed-loop reconstruction for FIR *and* LPC lanes in ONE vmapped
    scan: per-lane taps (``coeffs[l, 1:]``), tap count ``order[l]``
    (grown as ``min(n, order)`` during warmup), predictor shift
    ``shift[l]`` (2 for FIR, 15 for LPC) and prediction start
    ``min_pred_n[l]`` (FIR emits raw samples for n < 2; LPC's n=0 case
    falls out of the empty tap sum).

    ``res``: (G, L); ``coeffs``: (G, >=33). Returns (int64 (G, L), ok (G,)).
    """
    res = np.asarray(res) if not is_jax(xp) else res
    if not is_jax(xp):
        y = np.asarray(res).astype(np.int64).copy()
        G, L = y.shape
        nv = np.full(G, L) if valid_len is None else np.asarray(valid_len)
        cs = np.asarray(coeffs, dtype=np.int64)
        ok = np.ones(G, dtype=bool)
        for g in range(G):
            r, c = y[g], cs[g]
            od, sh, mp = int(order[g]), int(shift[g]), int(min_pred_n[g])
            for n in range(int(nv[g])):
                taps = min(od, n)
                acc = 0
                for i in range(1, taps + 1):
                    acc += int(c[i]) * int(r[n - i])
                s = int(r[n]) + ((acc >> sh) if n >= mp else 0)
                if s < C.INT32_MIN or s > C.INT32_MAX:
                    ok[g] = False
                    break
                r[n] = s
        return y, ok

    import jax
    import jax.numpy as jnp

    res = jnp.asarray(res, dtype=jnp.int64)
    G, L = res.shape
    omax = int(np.max(np.asarray(order), initial=2))
    H = next(h for h in (4, 8, 12, 16, 32) if h >= omax)  # static tap bound
    cs = jnp.asarray(coeffs, dtype=jnp.int64)[:, 1 : H + 1]
    od = jnp.asarray(order, jnp.int64)
    sh = jnp.asarray(shift, jnp.int64)
    mp = jnp.asarray(min_pred_n, jnp.int64)
    nv = (jnp.full((G,), L, jnp.int64) if valid_len is None
          else jnp.asarray(valid_len, jnp.int64))

    def one(r, c, od_l, sh_l, mp_l, n_valid):
        def step(carry, rn):
            hist, i, ok = carry
            taps_mask = jnp.arange(H) < jnp.minimum(i, od_l)
            acc = jnp.sum(jnp.where(taps_mask, c * hist, 0))
            pred = jnp.where(i >= mp_l, acc >> sh_l, 0)
            s = rn + pred
            in_range = (s >= C.INT32_MIN) & (s <= C.INT32_MAX)
            active = i < n_valid
            ok = ok & (in_range | ~active)
            s = jnp.where(active, s, rn)
            hist = jnp.concatenate([s[None], hist[:-1]])
            return (hist, i + 1, ok), s

        (_, _, ok), out = jax.lax.scan(step, (jnp.zeros((H,), jnp.int64), jnp.int64(0), True), r)
        return out, ok

    out, ok = jax.vmap(one)(res, cs, od, sh, mp, nv)
    return out, ok


def _fir_restore_jax(res, valid_len):
    import jax
    import jax.numpy as jnp

    res = jnp.asarray(res, dtype=jnp.int64)
    L = res.shape[-1]
    nv = jnp.full(res.shape[:-1], L, dtype=jnp.int64) if valid_len is None else jnp.broadcast_to(jnp.asarray(valid_len, jnp.int64), res.shape[:-1])

    def one(r, n_valid):
        def step(carry, rn_i):
            x1, x2, i, ok = carry
            rn, = rn_i
            pred = jnp.where(i >= C.FIR_ORDER, (3 * x1 - x2) >> 2, 0)
            s = rn + pred
            in_range = (s >= C.INT32_MIN) & (s <= C.INT32_MAX)
            active = i < n_valid
            ok = ok & (in_range | ~active)
            s = jnp.where(active, s, rn)
            return (s, x1, i + 1, ok), s

        (_, _, _, ok), out = jax.lax.scan(step, (jnp.int64(0), jnp.int64(0), jnp.int64(0), True), (r,))
        return out, ok

    flat = res.reshape(-1, L)
    out, ok = jax.vmap(one)(flat, nv.reshape(-1))
    return out.reshape(res.shape), ok.reshape(res.shape[:-1])


def _lpc_restore_jax(res, coeffs_q15, order, valid_len):
    import jax
    import jax.numpy as jnp

    res = jnp.asarray(res, dtype=jnp.int64)
    L = res.shape[-1]
    coeffs = jnp.asarray(coeffs_q15, dtype=jnp.int64)
    coeffs = jnp.broadcast_to(coeffs, res.shape[:-1] + (coeffs.shape[-1],))
    nv = jnp.full(res.shape[:-1], L, dtype=jnp.int64) if valid_len is None else jnp.broadcast_to(jnp.asarray(valid_len, jnp.int64), res.shape[:-1])

    def one(r, c, n_valid):
        hist0 = jnp.zeros((order,), dtype=jnp.int64)  # hist[j] = x[n-1-j]
        cs = c[1 : order + 1]

        def step(carry, rn_i):
            hist, i, ok = carry
            rn, = rn_i
            taps_mask = jnp.arange(order) < jnp.minimum(i, order)
            acc = jnp.sum(jnp.where(taps_mask, cs * hist, 0))
            s = rn + (acc >> 15)
            in_range = (s >= C.INT32_MIN) & (s <= C.INT32_MAX)
            active = i < n_valid
            ok = ok & (in_range | ~active)
            s = jnp.where(active, s, rn)
            hist = jnp.concatenate([s[None], hist[:-1]])
            return (hist, i + 1, ok), s

        (_, _, ok), out = jax.lax.scan(step, (hist0, jnp.int64(0), True), (r,))
        return out, ok

    flat = res.reshape(-1, L)
    cflat = coeffs.reshape(-1, coeffs.shape[-1])
    out, ok = jax.vmap(one)(flat, cflat, nv.reshape(-1))
    return out.reshape(res.shape), ok.reshape(res.shape[:-1])
