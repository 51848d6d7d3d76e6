"""On-device bitstream packing (prefix-sum offsets + word scatter-add).

The host emitter (`lac_emit_blocks_planes`, runtime/src/lac_runtime.cpp)
serially packs each lane's token stream; this module is the
array-program formulation of the same emission for the device: element bit
lengths prefix-sum into bit offsets, and every element's bits land in
the output u32 words via a bounded number of scatter-adds. It exists to
answer SURVEY §2 C1's open question — "can the token body be packed on
device?" — with a byte-exact, measurable prototype (the packed words
are bit-identical to `bitio.pack.pack_stream` / the native BitSink).

Element model (same as bitio/pack.py): each element is ``unary`` ONE
bits followed by a ``fl``-bit MSB-first field holding ``fv``. A Rice
token is one element: ``unary=q, fl=k+1, fv=remainder`` (the field's
leading 0 is the stop bit; reference rice.cpp:17-32).

Word decomposition (all regions of distinct elements are disjoint, so
scatter-ADD composes them without carries):

* field: lands in at most two consecutive words; one u64 shift places
  it in a 64-bit window, contributing the high/low halves.
* unary run [a, b): split into a partial head word, a span of full
  0xFFFFFFFF words, and a partial tail word. The full span is a range
  update — +1/-1 into a per-word delta array whose prefix sum marks
  fully-covered words (runs are disjoint, so the indicator is 0/1).

Total cost per element batch: 5 scatter-adds + 1 cumsum over words —
no per-bit materialization, no data-dependent shapes.

Bit order matches the wire: bit 0 of the stream is the MSB of word 0
(the native BitSink's bswap32 store order, lac_runtime.cpp BitSink).
"""

import numpy as np


def words_capacity(max_bits):
    """Output words for a lane whose stream is at most ``max_bits``."""
    return (int(max_bits) + 31) // 32


def pack_elements(unary, fv, fl, W, xp=np):
    """Pack element batches into u32 words, MSB-first.

    ``unary``: (..., M) int32/int64 leading one-bit counts (>= 0, may
    exceed 64 — long unary runs are range updates, not shifts).
    ``fv``: (..., M) uint32 field values (< 2**fl).
    ``fl``: (..., M) int32 field lengths in [0, 32].
    ``W``: static output width in words; bits beyond 32*W MUST be absent
    (callers size W from the lane's cost bound). Padding elements are
    ``unary=0, fl=0``.

    Returns ``(words, total_bits)``: (..., W) uint32 and (...,) int32.
    """
    u64 = xp.uint64
    u32 = xp.uint32
    if unary.shape[-1] == 0:
        lead = unary.shape[:-1]
        return (xp.zeros(lead + (W,), dtype=u32), xp.zeros(lead, dtype=xp.int32))
    unary = unary.astype(xp.int64)
    fl = fl.astype(xp.int64)
    elem = unary + fl
    off = xp.cumsum(elem, axis=-1) - elem  # exclusive prefix sum
    total_bits = (off[..., -1] + elem[..., -1]).astype(xp.int32)

    lead = unary.shape[:-1]
    M = unary.shape[-1]
    B = int(np.prod(lead)) if lead else 1
    unary = unary.reshape(B, M)
    fl = fl.reshape(B, M)
    off = off.reshape(B, M)
    fv = fv.reshape(B, M).astype(u32)

    W1 = W + 1  # +1 word absorbs zero spill of field low halves
    lane = xp.arange(B, dtype=xp.int64)[:, None] * xp.int64(W1)

    # ---- fields: one u64 window over words [w, w+1] ------------------
    s = off + unary
    w = s >> xp.int64(5)
    sh = s & xp.int64(31)
    # place fv at bits [sh, sh+fl) of the window; fl=0 contributes 0.
    # The shift amount is clamped below 64 BEFORE shifting (shift-by-64
    # on u64 is undefined in XLA), then the fl=0 case is zeroed.
    shift = xp.where(fl > 0, xp.int64(64) - sh - fl, xp.int64(0)).astype(u64)
    c64 = xp.where(fl > 0, fv.astype(u64) << shift, u64(0))
    flat = xp.zeros(B * W1, dtype=u32)
    idx = (lane + w).reshape(-1)
    flat = _scat(flat, idx, (c64 >> u64(32)).astype(u32), xp)
    flat = _scat(flat, idx + 1, (c64 & u64(0xFFFFFFFF)).astype(u32), xp)

    # ---- unary runs [a, b): head word, full span, tail word ----------
    a = off
    b = off + unary
    wa = a >> xp.int64(5)
    wb = b >> xp.int64(5)
    abit = a & xp.int64(31)
    len_h = xp.minimum(unary, xp.int64(32) - abit)
    mask_h = (((u64(1) << len_h.astype(u64)) - u64(1))
              << (xp.int64(32) - abit - len_h).astype(u64)).astype(u32)
    mask_h = xp.where(len_h > 0, mask_h, u32(0))
    flat = _scat(flat, (lane + wa).reshape(-1), mask_h, xp)

    len_t = b & xp.int64(31)
    tail_sh = xp.where(len_t > 0, xp.int64(32) - len_t, xp.int64(0)).astype(u64)
    mask_t = xp.where(
        (wb > wa) & (len_t > 0),
        (u64(0xFFFFFFFF) << tail_sh).astype(u32),
        u32(0),
    )
    flat = _scat(flat, (lane + wb).reshape(-1), mask_t, xp)

    # full-word span [wa+1, wb): delta range update + prefix sum.
    # When the run ends inside its first word the pair lands as
    # d[wa+1]+=1, d[wa or wa+1]-=1 — net zero from wa+1 on, and the
    # spurious -1 at wa can never flip a disjoint run's covered word.
    delta = xp.zeros(B * W1 + 1, dtype=xp.int32)
    delta = _scat(delta, (lane + wa + 1).reshape(-1), xp.ones_like(mask_h, xp.int32), xp)
    delta = _scat(delta, (lane + wb).reshape(-1), -xp.ones_like(mask_h, xp.int32), xp)
    # the cumsum runs per lane (reshape isolates lanes), so runs never
    # leak across lane boundaries
    cover = xp.cumsum(delta[:-1].reshape(B, W1), axis=-1) > 0
    words = flat.reshape(B, W1) | xp.where(cover, u32(0xFFFFFFFF), u32(0))

    return words[:, :W].reshape(lead + (W,)), total_bits.reshape(lead)


def _scat(flat, idx, val, xp):
    # out-of-bounds indices only ever carry zero contributions (the
    # field low-half of a stream ending exactly at 32*W) — drop them
    if xp is np:
        idx = np.asarray(idx).reshape(-1)
        val = np.asarray(val).reshape(-1)
        ok = idx < flat.shape[0]
        np.add.at(flat, idx[ok], val[ok])
        return flat
    return flat.at[idx].add(val.reshape(-1), mode="drop")


def rice_elements(u, k_used, xp=np):
    """Per-sample Rice token elements (modes 0 and 3; format.md §5.1).

    ``u``: (..., L) uint64 zigzag codes; ``k_used``: (..., L) int32 the
    per-sample encoding k (k_used_* from ops.adapt, or a broadcast
    static k for mode 3). Returns (unary, fv, fl).

    The emitter computes ``q = u >> k`` for every ``k <= 31``
    (reference rice.cpp:17-32; the k>=31 q=0 special case lives only in
    the *cost model*, format.md §5.1).
    """
    k = k_used.astype(xp.uint64)
    unary = (u.astype(xp.uint64) >> k).astype(xp.int64)
    fl = (k_used + 1).astype(xp.int64)
    fv = (u.astype(xp.uint64) & ((xp.uint64(1) << k) - xp.uint64(1))).astype(xp.uint32)
    return unary, fv, fl


def zigzag(res, xp=np):
    """Signed residual -> unsigned code (format.md §5.2)."""
    r = res.astype(xp.int32)
    return ((r.astype(xp.uint32) << xp.uint32(1))
            ^ xp.where(r < 0, xp.uint32(0xFFFFFFFF), xp.uint32(0))).astype(xp.uint64)


def pack_rice_lanes(u, k_used, W, xp=np):
    """Pack whole rice-coded lanes (one token per sample) to words.

    Convenience wrapper: elements = rice tokens of ``u`` under
    ``k_used``; returns (words, total_bits).
    """
    unary, fv, fl = rice_elements(u, k_used, xp=xp)
    return pack_elements(unary, fv, fl, W, xp=xp)
