#!/usr/bin/env python
"""Same-session interleaved A/B of the partial-chunk upload buckets
(LAC_TPU_UPLOAD_BUCKETS) on the 30 s bench corpus (80 full blocks at
K=128: the bucketed upload ships 96 rows + device pad instead of a
host-padded 128 — 25% fewer upload bytes).

Usage: python scripts/time_upload_buckets.py [ROUNDS]
"""

import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("LAC_TPU_COLD_BLOCKS", "0")

from lac_tpu.encoder import FrameEncoder  # noqa: E402

SR = 44100
FRAMES = SR * 30


def corpus(seed):
    rng = np.random.RandomState(seed)
    t = np.arange(FRAMES, dtype=np.float64)
    sig = sum(
        rng.uniform(2000, 9000) * np.sin(2 * np.pi * rng.uniform(80, 4000) * t / SR)
        for _ in range(3)
    )
    left = np.clip(sig + rng.randint(-1500, 1500, FRAMES), -32768, 32767).astype(np.int32)
    right = np.clip(sig * 0.6 + rng.randint(-800, 800, FRAMES), -32768, 32767).astype(np.int32)
    return left, right


def main():
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    import jax.numpy as jnp

    variants = sys.argv[2].split(",") if len(sys.argv) > 2 else ["off", "4", "8"]

    def set_variant(v):
        if v == "off":
            os.environ["LAC_TPU_UPLOAD_BUCKETS"] = "0"
        else:
            os.environ["LAC_TPU_UPLOAD_BUCKETS"] = "1"
            os.environ["LAC_TPU_UPLOAD_BUCKET_DIV"] = v

    enc = FrameEncoder(12, 2, SR, 16, xp=jnp)
    # warm every variant (loads every executable incl. the pads)
    for v in variants:
        set_variant(v)
        enc.encode(*corpus(1))
    times = {v: [] for v in variants}
    seed = 100
    for r in range(rounds):
        order = variants if r % 2 == 0 else variants[::-1]
        for v in order:
            set_variant(v)
            left, right = corpus(seed)
            seed += 1
            t0 = time.perf_counter()
            enc.encode(left, right)
            times[v].append(time.perf_counter() - t0)
    for v in variants:
        ts = sorted(times[v])
        label = "host-pad-to-K" if v == "off" else f"bucketed div={v}"
        print(f"{label}: best {ts[0]*1e3:.1f} ms  median {ts[len(ts)//2]*1e3:.1f} ms "
              f"(best {FRAMES/ts[0]/1e6:.2f} M fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
