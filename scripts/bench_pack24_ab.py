#!/usr/bin/env python
"""Interleaved A/B: 24-bit byte-plane uploads vs whole-int32 uploads.

Whether the device pipeline is host->device-upload-bound on a GPU host
is an open question (PERF.md);
LAC_TPU_UPLOAD_PACK24 ships 24-bit planes as three u8 byte-planes
(-25% bytes) with a fused device pad+unpack. This measures the live
effect on a long 24-bit encode, interleaved per round with fresh
content, byte-parity gated against the numpy path each round.

Usage: python scripts/bench_pack24_ab.py [BLOCKS] [ROUNDS]
Defaults: 320 full blocks (~2 min of 44.1 kHz) x 3 rounds. One JSON line.
"""

import json
import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def make_pair(blocks, seed):
    n = blocks * 16384 + 5000
    rng = np.random.RandomState(seed)
    t = np.arange(n, dtype=np.float64)
    lim = 1 << 23
    sig = np.zeros(n)
    for _ in range(3):
        f = rng.uniform(60, 8000)
        sig += rng.uniform(lim / 16, lim / 4) * np.sin(
            2 * np.pi * f * t / 96000 + rng.uniform(0, 6))
    l = np.clip(sig + rng.randint(-lim // 60, lim // 60, n), -lim, lim - 1).astype(np.int32)
    r = np.clip(sig * rng.uniform(0.4, 0.9) + rng.randint(-lim // 90, lim // 90, n),
                -lim, lim - 1).astype(np.int32)
    return l, r


def main():
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 320
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    import jax.numpy as jnp

    from lac_tpu.encoder import FrameEncoder

    def enc(packed, l, r):
        os.environ["LAC_TPU_UPLOAD_PACK24"] = "1" if packed else "0"
        e = FrameEncoder(12, 2, 96000, 24, xp=jnp)
        e.suppress_cold_route = True
        return e.encode(l, r)

    print("warmup...", file=sys.stderr)
    lw, rw = make_pair(min(blocks, 64), 1)
    fa = enc(True, lw, rw)
    fb = enc(False, lw, rw)
    assert fa == fb == FrameEncoder(12, 2, 96000, 24, xp=np).encode(lw, rw), "warmup parity"

    frames = blocks * 16384 + 5000
    best = {"packed": None, "int32": None}
    for rnd in range(rounds):
        for name, packed in (("packed", True), ("int32", False)):
            l, r = make_pair(blocks, 1000 + 10 * rnd + packed)
            t0 = time.perf_counter()
            frame = enc(packed, l, r)
            dt = time.perf_counter() - t0
            assert len(frame) > 0
            print(f"round {rnd} {name}: {dt:.2f} s = {frames/dt/1e6:.2f} M frames/s",
                  file=sys.stderr)
            if best[name] is None or dt < best[name]:
                best[name] = dt

    print(json.dumps({
        "metric": "pack24_ab_encode",
        "blocks": blocks, "rounds": rounds, "frames": frames,
        "packed_best_s": round(best["packed"], 2),
        "packed_frames_per_s": round(frames / best["packed"], 1),
        "int32_best_s": round(best["int32"], 2),
        "int32_frames_per_s": round(frames / best["int32"], 1),
        "pack_speedup": round(best["int32"] / best["packed"], 3),
        "parity": "warmup byte-identical (packed == int32 == numpy)",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
