"""A/B: batched device bit-reader prototype vs the native product reader.

Answers SURVEY §2 C2's open question with a measurement (VERDICT r4 #4):
parse L lanes x T static-k Rice tokens with

  (a) the native 64-bit-windowed reader (`lac_tokenize_static_rice`,
      runtime/src/lac_runtime.cpp — the same read_rice_u the product
      decode uses), and
  (b) the device pointer-jumping parse (`ops/device_reader.py`).

Outputs are asserted equal before timing. Device runs use fresh content
per timed pass and are forced with a tiny fetch. Usage:

    python scripts/bench_device_reader.py [LANES] [TOKENS] [REPS]
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from lac_tpu.ops.device_reader import (  # noqa: E402
    encode_static_rice_np,
    tokenize_static_rice,
)
from lac_tpu.runtime.native import tokenize_static_rice_native  # noqa: E402


def make_lanes(rng, L, T, nby=None):
    """``nby``: fixed payload width so fresh-content timed reps reuse
    one executable (shape diversity = recompiles, not measurement)."""
    ks = rng.randint(2, 13, L).astype(np.int32)
    vals = np.empty((L, T), np.int32)
    payloads, nbits = [], []
    for li in range(L):
        scale = 1 << ks[li]
        v = (rng.standard_normal(T) * scale * 0.6).astype(np.int32)
        vals[li] = v
        p, nb = encode_static_rice_np(v, int(ks[li]))
        payloads.append(p)
        nbits.append(nb)
    if nby is None:
        nby = (max(len(p) for p in payloads) * 9) // 8 + 16
    pay = np.zeros((L, nby), np.uint8)
    for li, p in enumerate(payloads):
        assert len(p) <= nby, "fixed payload width too small for content"
        pay[li, : len(p)] = p
    return pay, ks, np.asarray(nbits, np.int64), vals


def main():
    L = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    T = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    reps = int(sys.argv[3]) if len(sys.argv) > 3 else 5
    rng = np.random.RandomState(11)

    import jax
    import jax.numpy as jnp

    import lac_tpu

    lac_tpu.configure_jax()

    pay, ks, nbits, vals = make_lanes(rng, L, T)
    res_n = tokenize_static_rice_native(pay, ks, nbits, T)
    assert res_n is not None, "native runtime unavailable"
    np.testing.assert_array_equal(res_n, vals)

    fn = jax.jit(lambda p, k, nb: tokenize_static_rice(p, k, nb, T, xp=jnp))
    out = fn(jnp.asarray(pay), jnp.asarray(ks), jnp.asarray(nbits, np.int32))
    np.testing.assert_array_equal(np.asarray(out[0]), vals)
    print(f"parity ok: {L} lanes x {T} tokens, device == native == truth",
          file=sys.stderr)

    best_n = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        tokenize_static_rice_native(pay, ks, nbits, T)
        best_n = min(best_n, time.perf_counter() - t0)

    from lac_tpu.ops.device_reader import tokenize_static_rice_scan

    fn_scan = jax.jit(lambda p, k, nb: tokenize_static_rice_scan(p, k, nb, T))
    out2 = fn_scan(jnp.asarray(pay), jnp.asarray(ks), jnp.asarray(nbits, np.int32))
    np.testing.assert_array_equal(np.asarray(out2[0]), vals)
    print("scan-variant parity ok", file=sys.stderr)

    nby = pay.shape[1]

    def time_device(f):
        best = float("inf")
        for i in range(reps):
            fp, fk, fnb, _ = make_lanes(np.random.RandomState(100 + i), L, T,
                                        nby=nby)
            fpj, fkj, fnbj = (jnp.asarray(fp), jnp.asarray(fk),
                              jnp.asarray(fnb, np.int32))
            t0 = time.perf_counter()
            r = f(fpj, fkj, fnbj)
            np.asarray(r[0][0, :4])  # tiny forcing fetch
            best = min(best, time.perf_counter() - t0)
        return best

    best_d = time_device(fn)
    best_s = time_device(fn_scan)

    tokens = L * T
    print(json.dumps({
        "metric": "static_rice_tokenize",
        "lanes": L, "tokens_per_lane": T,
        "native_tokens_per_s": round(tokens / best_n, 1),
        "device_jump_tokens_per_s": round(tokens / best_d, 1),
        "device_scan_tokens_per_s": round(tokens / best_s, 1),
        "jump_vs_native": round(best_n / best_d, 4),
        "scan_vs_native": round(best_n / best_s, 4),
    }))


if __name__ == "__main__":
    sys.exit(main())
