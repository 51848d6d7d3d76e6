"""LPC analysis: exact autocorrelation + Levinson-Durbin + Q15 quantization.

Parity-critical numerics (lpc.cpp:64-186):

* autocorrelation lags are *exact* int64 sums (up to ~2^60 for 24-bit
  blocks) — they exceed f64's exact-integer range, and the reference
  feeds them to an 80-bit ``long double`` recursion. We therefore run
  Levinson-Durbin vectorized over blocks in ``np.longdouble`` (the same
  x87 80-bit type on x86-64) on the host; the heavy lag computation runs
  batched on device.
* Levinson-Durbin is order-recursive: one recursion to order 12 yields
  the coefficient sets of every candidate order {4,6,8,10,12} as
  snapshots — the reference recomputes the recursion per candidate
  (block/encoder.cpp:382-407) but the intermediate states are identical.
* Q15 quantization: cast to double, scale by 32768, round half away
  from zero, clamp to int16 (lpc.cpp:73-78).
"""

import numpy as np

from ._backend import is_jax

# Byte parity depends on np.longdouble being the x87 80-bit extended type
# (matching the reference's `long double` on x86-64). On aarch64/Windows
# longdouble is 64- or 128-bit and would silently produce near-but-not-
# byte-identical streams — fail loudly instead (machep -63 <=> 64-bit
# mantissa).
_LD_MACHEP = np.finfo(np.longdouble).machep


def _require_x87_longdouble():
    if _LD_MACHEP != -63:
        raise RuntimeError(
            "np.longdouble is not the x86 80-bit extended type on this host "
            f"(machep {_LD_MACHEP}, expected -63): Levinson-Durbin would "
            "diverge from the reference's long double and break .lac byte "
            "parity. Run the encoder on an x86-64 host."
        )


def autocorrelation(x, max_order, xp=np):
    """Exact int64 lags 0..max_order: R[k] = sum_n x[n] * x[n-k].

    ``x``: (..., L) int32. Returns (..., max_order+1) int64.
    (lpc.cpp:80-96; sums are exact in int64 for <= 2^60.)
    """
    x64 = x.astype(xp.int64)
    lags = []
    for k in range(max_order + 1):
        if k == 0:
            lags.append(xp.sum(x64 * x64, axis=-1))
        else:
            lags.append(xp.sum(x64[..., k:] * x64[..., :-k], axis=-1))
    return xp.stack(lags, axis=-1)


def nlimbs_for_maxabs(maxabs):
    """Limb count for :func:`autocorrelation_limbs`: smallest ``nl`` with
    ``|x| < 2^(5*nl - 1)`` (signed top limb covers the sign bit)."""
    need = int(maxabs).bit_length() + 1  # signed range bits
    return max(1, -(-need // 5))


def autocorrelation_limbs(x, max_order, nlimbs, xp=np):
    """Exact autocorrelation as 5-bit-limb Gram matmuls.

    Byte-identical to :func:`autocorrelation` for ``|x| < 2^(5*nlimbs-1)``
    but with the lag arithmetic as bf16 matrix products instead of int64
    multiply-add loops:

    * ``x = sum_a limb_a(x) * 2^(5a)`` with unsigned 5-bit low limbs and
      an arithmetic-shift signed top limb — every limb value is <= 31 in
      magnitude, hence **exact in bfloat16**;
    * each lag becomes a limb-pair Gram ``G_k[a,b] = sum_n limb_a[n-k] *
      limb_b[n]``, one batched ``dot_general`` per lag with f32
      accumulation. Every product is an integer < 2^10 and every partial
      sum an integer <= L * 961 <= 16384 * 961 < 2^24, so f32
      accumulation is exact in any order (split-K GEMMs included; TF32
      does not apply to bf16 operands);
    * the tiny (.., max_order+1, nl, nl) Gram recombines in int64 with
      weights ``2^(5(a+b))`` — exact for 24-bit blocks (|R| < 2^60, as
      in the reference's int64 accumulation, lpc.cpp:80-96).

    Requires ``L <= 16384`` (= MAX_BLOCK_SIZE) for the 2^24 bound.
    ``chip_smoke.py`` checks the bit-equality on the GPU at (256, 16384).
    """
    lead = x.shape[:-1]
    L = x.shape[-1]
    assert L <= 16384, "f32-exactness bound requires L <= 16384"
    x32 = x.astype(xp.int32)
    ldt = np.float32
    if is_jax(xp):
        import jax.numpy as jnp

        ldt = jnp.bfloat16
    limbs = []
    for a in range(nlimbs):
        la = x32 >> xp.int32(5 * a)
        if a < nlimbs - 1:
            la = la & xp.int32(31)
        limbs.append(la.astype(ldt))
    Lm = xp.stack(limbs, axis=-2)  # (..., nl, L) — L minor-most: clean tiling
    nl = nlimbs
    nk = max_order + 1
    # lagged operands via one front-pad + static slices (x[n-k] = 0, n < k)
    pad = [(0, 0)] * (Lm.ndim - 2) + [(0, 0), (max_order, 0)]
    Lp = xp.pad(Lm, pad)
    nb = len(lead)
    outs = []
    for k in range(nk):
        Lk = Lp[..., max_order - k : max_order - k + L]
        if is_jax(xp):
            import jax
            import jax.numpy as jnp

            G = jax.lax.dot_general(
                Lk, Lm,
                dimension_numbers=(((nb + 1,), (nb + 1,)), (tuple(range(nb)), tuple(range(nb)))),
                preferred_element_type=jnp.float32,
            )  # (..., nl, nl)
        else:
            G = np.einsum("...an,...bn->...ab", Lk.astype(np.float32), Lm.astype(np.float32))
        outs.append(G)
    G = xp.stack(outs, axis=-3).astype(xp.int64)  # (..., nk, nl, nl)
    w = (np.arange(nl, dtype=np.int64)[:, None] + np.arange(nl, dtype=np.int64)[None, :])
    weights = xp.asarray((np.int64(1) << (5 * w)).reshape(nl * nl))
    return xp.sum(G.reshape(lead + (nk, nl * nl)) * weights, axis=-1)


def levinson_durbin_snapshots(R, max_order):
    """Vectorized 80-bit Levinson-Durbin with per-step snapshots.

    ``R``: (B, max_order+1) exact integer lags (any integer dtype or
    longdouble). Returns:

    * ``A``: (max_order+1, B, max_order+1) longdouble — ``A[i]`` is the
      coefficient state after step ``i`` (``A[0]`` all zero),
    * ``break_step``: (B,) int32 — the step at which the recursion broke
      (max_order+1 if it completed). For a candidate order ``c`` the
      achieved order is ``c if break_step > c else break_step - 1``.

    Numerics follow lpc.cpp:98-154: eps=1e-8, reflection clamp +-0.999,
    inner products accumulated in ascending-j order (FP order matters),
    energy floor R[0] -> max(R[0], 1.0) applied by the caller.
    """
    _require_x87_longdouble()
    ld = np.longdouble
    R = np.asarray(R, dtype=ld)
    B = R.shape[0]
    eps = ld("1e-8")

    E = R[:, 0].copy()
    a = np.zeros((B, max_order + 1), dtype=ld)
    prevA = np.zeros((B, max_order + 1), dtype=ld)
    A = np.zeros((max_order + 1, B, max_order + 1), dtype=ld)
    # lanes whose E[0] is non-finite or < eps never start (achieved 0)
    alive = np.isfinite(E) & (E >= eps)
    break_step = np.where(alive, np.int32(max_order + 1), np.int32(1))

    for i in range(1, max_order + 1):
        acc = np.zeros(B, dtype=ld)
        for j in range(1, i):
            acc = acc + prevA[:, j] * R[:, i - j]

        denom = E
        step_alive = alive & np.isfinite(denom) & (denom >= eps)
        safe_denom = np.where(step_alive, denom, ld(1))
        ki = (R[:, i] - acc) / safe_denom
        step_alive = step_alive & np.isfinite(ki)
        ki = np.clip(ki, ld("-0.999"), ld("0.999"))

        e_new = (ld(1) - ki * ki) * E
        dead_at_e = step_alive & (~np.isfinite(e_new) | (e_new < eps))
        step_alive = step_alive & ~dead_at_e

        # a[i] = ki; a[j] = prevA[j] - ki * prevA[i-j] for alive lanes
        new_a = a.copy()
        new_a[:, i] = ki
        for j in range(1, i):
            new_a[:, j] = prevA[:, j] - ki * prevA[:, i - j]
        upd = step_alive
        a = np.where(upd[:, None], new_a, a)
        prevA = np.where(upd[:, None], a, prevA)
        E = np.where(upd, e_new, E)

        newly_dead = alive & ~step_alive
        break_step = np.where(newly_dead, np.int32(i), break_step)
        alive = step_alive
        A[i] = a

    return A, break_step


def achieved_order(break_step, cand_order):
    """Achieved order for a candidate max order (see snapshots doc)."""
    return np.where(break_step > cand_order, cand_order, break_step - 1).astype(np.int32)


def quantize_q15(coeffs):
    """double -> signed Q15 with round-half-away-from-zero + clamp
    (lpc.cpp:73-78)."""
    c = np.asarray(coeffs, dtype=np.float64)
    scaled = c * 32768.0
    rounded = np.trunc(scaled + np.copysign(0.5, scaled))
    return np.clip(rounded, -32768.0, 32767.0).astype(np.int16)


def analyze_blocks(x, max_order=12, xp=np):
    """Batched ``analyze_block_q15`` (lpc.cpp:156-186) for all candidate
    orders at once.

    ``x``: (B, L) int32 blocks. Returns dict with:

    * ``R``: (B, max_order+1) int64 exact lags,
    * ``A``: longdouble snapshots (see above),
    * ``break_step``: (B,) int32.
    """
    R = autocorrelation(x, max_order, xp=xp)
    R = np.asarray(R)  # device -> host for the tiny recursion
    Rld = np.asarray(R, dtype=np.longdouble)
    # energy floor: R[0] = max(R[0], 1.0) (min_energy, lpc.cpp:169-172)
    Rld[:, 0] = np.maximum(Rld[:, 0], np.longdouble(1))
    A, break_step = levinson_durbin_snapshots(Rld, max_order)
    return {"R": R, "A": A, "break_step": break_step}


def candidate_coeffs_q15(analysis, cand_order):
    """Q15 coefficient set + achieved order for one candidate order.

    Returns (coeffs (B, cand_order+1) int16, used_order (B,) int32,
    stable (B,) bool). Coefficients above the achieved order are zero
    (lpc.cpp:176-183).
    """
    A, break_step = analysis["A"], analysis["break_step"]
    B = A.shape[1]
    ach = achieved_order(break_step, cand_order)
    # snapshot at the achieved step for each lane
    snap = A[ach, np.arange(B), :]  # (B, max_order+1) longdouble
    q = quantize_q15(snap.astype(np.float64))
    cols = np.arange(A.shape[2])[None, :]
    mask = (cols >= 1) & (cols <= ach[:, None])
    coeffs = np.where(mask, q, np.int16(0)).astype(np.int16)[:, : cand_order + 1]
    return coeffs, ach, ach > 0
