"""Batched on-device bit-reader for static-mode Rice partitions.

SURVEY §2 C2 left one design question open: can the decode-side token
parse — the reference's bit-serial hot loop
(/root/reference/src/codec/block/decoder.cpp:104-306) — run batched on
the device? Emission has a byte-exact prototype (`ops/device_pack.py`);
this module is the decode twin: a measurable, bit-exact prototype for
the one mode whose parse is a pure function of the bits, **static-mode
partitions** (fixed k for the whole segment, reference
block/decoder.cpp:296-303). Adaptive-mode
parses need the k recurrence (rice.hpp:45-114) whose state depends on
every previously decoded value, so their boundaries cannot be jumped
ahead of decoding; static mode has no such feedback, making it the
honest upper bound for any device parse.

Formulation (no per-token loop):

1. bytes -> bit planes (elementwise shifts);
2. ``nz[p]`` = first zero bit at/after ``p`` — a reverse ``cummin``
   over ``where(bit==0, index, +inf)``;
3. a token starting at ``p`` ends its unary run at ``nz[p]`` and the
   next token starts at ``step[p] = nz[p] + 1 + k`` — token boundaries
   are the orbit of 0 under ``step``. The orbit is materialized with
   pointer doubling: ``log2(max_tokens)`` rounds of ``J = J[J]`` plus a
   doubling start list (list ranking), i.e. gathers instead of a serial
   chain;
4. values: ``q = nz[s] - s``; the k remainder bits load from a gathered
   32-bit byte window; ``u = (q << k) | rem``; zigzag inverse
   (rice.cpp:7-15) gives the residual.

Cost model: ~log2(T) dynamic gathers over the bit axis per lane — a
far costlier op class than an elementwise pass, which is why this is a
prototype with a benchmark (scripts/bench_device_reader.py) and not a
product path until measured on the GPU.

Wire rules honored: MSB-first bit order (bit_reader.hpp:92-112), k is
the static field k (<= MAX_STATIC_K = 15, block/encoder.cpp:160-180),
zigzag map (format.md:224-236).
"""

import numpy as np

from ..format import constants as C


def _bits_from_bytes(payload, xp):
    """(..., NBY) uint8 -> (..., NBY*8) int32 bits, MSB-first."""
    b = payload.astype(xp.int32)
    shifts = xp.asarray(np.arange(7, -1, -1, dtype=np.int32))
    bits = (b[..., None] >> shifts) & xp.int32(1)
    return bits.reshape(*payload.shape[:-1], payload.shape[-1] * 8)


def tokenize_static_rice(payload, k, nbits, max_tokens, xp=np):
    """Parse ``max_tokens`` static-k Rice tokens from each lane.

    ``payload``: (L, NBY) uint8 byte payloads (zero-padded; a zero byte
    past the stream parses as harmless garbage beyond ``max_tokens``).
    ``k``: (L,) int32 static Rice parameter per lane (0..15).
    ``nbits``: (L,) int32 valid bit length per lane (token starts at or
    beyond this are reported invalid).
    ``max_tokens``: static token capacity (tokens per lane).

    Returns ``(residuals, starts, valid)``: (L, max_tokens) int32
    zigzag-decoded residuals, their bit offsets, and a validity mask.
    Bit-exact vs the scalar reference parse (tests/test_device_reader).
    """
    if xp is np:
        return _tokenize_np(payload, k, nbits, max_tokens)

    import jax.numpy as jnp
    from jax import lax

    L, NBY = payload.shape
    NB = NBY * 8
    bits = _bits_from_bytes(payload, jnp)  # (L, NB)
    pos = jnp.arange(NB, dtype=jnp.int32)
    # first zero at/after p (sentinel NB when the tail is all ones)
    idx0 = jnp.where(bits == 0, pos[None, :], jnp.int32(NB))
    nz = lax.cummin(idx0, axis=1, reverse=True)  # (L, NB)
    # next-token-start map with a fixpoint cell at NB
    step = jnp.minimum(nz + 1 + k[:, None].astype(jnp.int32), jnp.int32(NB))
    step = jnp.concatenate([step, jnp.full((L, 1), NB, jnp.int32)], axis=1)

    # orbit of 0 under `step` via doubling start lists (list ranking)
    starts = jnp.zeros((L, max_tokens), jnp.int32)
    size = 1
    J = step
    lanes = jnp.arange(L)[:, None]
    while size < max_tokens:
        take = min(size, max_tokens - size)
        nxt = J[lanes, starts[:, :take]]
        starts = lax.dynamic_update_slice(starts, nxt, (0, size))
        size += take
        if size < max_tokens:
            J = J[lanes, J]  # double the jump distance

    z = nz[lanes, jnp.minimum(starts, NB - 1)]
    q = (z - starts).astype(jnp.uint32)
    # k remainder bits from a 32-bit window of 4 gathered bytes
    bitpos = z + 1
    byteidx = jnp.minimum(bitpos >> 3, NBY - 4)
    pj = payload.astype(jnp.uint32)
    w = (
        (pj[lanes, byteidx] << 24)
        | (pj[lanes, byteidx + 1] << 16)
        | (pj[lanes, byteidx + 2] << 8)
        | pj[lanes, byteidx + 3]
    )
    off = (bitpos - (byteidx << 3)).astype(jnp.uint32)
    kk = k[:, None].astype(jnp.uint32)
    # clamp the shift for garbage tokens past the stream end (their
    # window clamp can push off+k past 32; they are masked by `valid`)
    shift = jnp.maximum(jnp.int32(32) - off.astype(jnp.int32) - kk.astype(jnp.int32), 0).astype(jnp.uint32)
    rem = (w >> shift) & ((jnp.uint32(1) << kk) - 1)
    u = (q << kk) | rem
    res = ((u >> jnp.uint32(1)) ^ (-(u & jnp.uint32(1)).astype(jnp.int32)).astype(jnp.uint32)).astype(jnp.int32)
    valid = starts < nbits[:, None]
    return res, starts, valid


def tokenize_static_rice_scan(payload, k, nbits, max_tokens, xp=None):
    """Scan formulation: one ``lax.scan`` step per TOKEN with all lanes
    advancing together — the array analog of the reference's
    thread-per-block decode (lanes = blocks/partitions, the serial
    chain stays per-lane). Each step loads one 64-bit window per lane,
    counts leading ones branchlessly, and extracts the remainder.

    Cap (documented, asserted by the caller's content): the whole token
    must fit one 64-bit window minus the byte offset — q + 1 + k <= 57.
    Real static partitions satisfy this overwhelmingly (k is chosen to
    keep quotients small; the estimator caps candidate k's precisely to
    bound unary runs, block/encoder.cpp:160-180); a product version
    would pre-scan for violations and fall back per lane.

    Returns (residuals, valid) of shape (L, max_tokens).
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    L, NBY = payload.shape
    pj = jnp.asarray(payload, dtype=jnp.uint64)
    kk = jnp.asarray(k, dtype=jnp.uint64)
    lanes = jnp.arange(L)

    def bit_length32(x):
        # exact integer MSB position+1 for x < 2^32 (no float log2)
        n = jnp.zeros_like(x)
        for s in (16, 8, 4, 2, 1):
            big = x >= (jnp.uint64(1) << jnp.uint64(s))
            n = jnp.where(big, n + jnp.uint64(s), n)
            x = jnp.where(big, x >> jnp.uint64(s), x)
        return n + x  # +1 when the remaining bit is set

    def clz64(x):
        hi = x >> jnp.uint64(32)
        lo = x & jnp.uint64(0xFFFFFFFF)
        hi_zero = hi == 0
        bl = jnp.where(hi_zero, bit_length32(lo), bit_length32(hi))
        lead = jnp.where(hi_zero, jnp.uint64(64), jnp.uint64(32)) - bl
        return jnp.where(x == 0, jnp.uint64(64), lead)

    def step(pos, _):
        byteidx = jnp.minimum(pos >> jnp.uint64(3), jnp.uint64(max(NBY - 8, 0)))
        w = jnp.zeros(L, jnp.uint64)
        for b in range(8):
            w = (w << jnp.uint64(8)) | pj[lanes, byteidx + jnp.uint64(b)]
        # clamp for garbage positions past the stream (masked by valid);
        # XLA leaves shifts >= bitwidth implementation-defined
        off = jnp.minimum(pos - (byteidx << jnp.uint64(3)), jnp.uint64(63))
        w = w << off  # low bits shift in as zeros (never all-ones)
        q = clz64(~w)
        rem = jnp.where(
            kk > 0, (w << (q + jnp.uint64(1))) >> (jnp.uint64(64) - kk), jnp.uint64(0)
        )
        u = ((q << kk) | rem).astype(jnp.uint32)
        res = ((u >> jnp.uint32(1)) ^ (-(u & jnp.uint32(1)).astype(jnp.int32)).astype(jnp.uint32)).astype(jnp.int32)
        start = pos
        return pos + q + jnp.uint64(1) + kk, (res, start.astype(jnp.int32))

    pos0 = jnp.zeros(L, jnp.uint64)
    _, (res, starts) = lax.scan(step, pos0, None, length=max_tokens)
    res = jnp.transpose(res)  # (L, max_tokens)
    valid = jnp.transpose(starts) < jnp.asarray(nbits, jnp.int32)[:, None]
    return res, valid


def _tokenize_np(payload, k, nbits, max_tokens):
    """Scalar spec twin (bit_reader.hpp:92-172 semantics, fixed k)."""
    L = payload.shape[0]
    res = np.zeros((L, max_tokens), np.int32)
    starts = np.zeros((L, max_tokens), np.int32)
    valid = np.zeros((L, max_tokens), bool)
    bits = np.unpackbits(payload, axis=1)
    for li in range(L):
        p = 0
        kk = int(k[li])
        for t in range(max_tokens):
            starts[li, t] = p
            valid[li, t] = p < int(nbits[li])
            q = 0
            while p < bits.shape[1] and bits[li, p]:
                q += 1
                p += 1
            p += 1  # stop bit
            rem = 0
            for _ in range(kk):
                rem = (rem << 1) | (int(bits[li, p]) if p < bits.shape[1] else 0)
                p += 1
            u = (q << kk) | rem
            res[li, t] = (u >> 1) ^ -(u & 1)
            if p >= bits.shape[1]:
                p = bits.shape[1]
    return res, starts, valid


def encode_static_rice_np(residuals, k):
    """Build the wire bytes for a static-k Rice token stream (test +
    bench fixture helper; matches rice.cpp:17-32 emission for k<=15)."""
    out = []
    nbits = 0
    acc = 0
    accn = 0
    for v in residuals:
        u = (int(v) << 1) ^ (int(v) >> 31) if v < 0 else (int(v) << 1)
        u &= 0xFFFFFFFF
        q = u >> k
        for chunk, chunkbits in ((0xFFFFFFFF, 32),) * (q // 32) + ((
            (1 << (q % 32)) - 1, q % 32),):
            acc = (acc << chunkbits) | chunk
            accn += chunkbits
            while accn >= 8:
                out.append((acc >> (accn - 8)) & 0xFF)
                accn -= 8
        acc = (acc << (k + 1)) | (u & ((1 << k) - 1))
        accn += k + 1
        nbits += q + 1 + k
        while accn >= 8:
            out.append((acc >> (accn - 8)) & 0xFF)
            accn -= 8
    if accn:
        out.append((acc << (8 - accn)) & 0xFF)
    return np.asarray(out, np.uint8), nbits
