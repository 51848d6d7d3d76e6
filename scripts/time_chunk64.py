#!/usr/bin/env python
"""Same-session A/B: K=64 chunking vs the default ladder (K=128) on the
30 s corpus (80 full blocks).

A single K=128 chunk has NO pipeline overlap — upload, analyze, plan,
fetch, emit run strictly serially. Two K=64 chunks flow through the
3-stage pipeline: chunk 1's upload/analyze/plan overlap chunk 0's plan
and host emit. The cost is smaller dispatches (more fixed per-dispatch
overhead) and an extra executable family to compile/load.

Usage: python scripts/time_chunk64.py [ROUNDS] [K_ALT]
"""

import os
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
os.environ.setdefault("LAC_TPU_COLD_BLOCKS", "0")

from lac_tpu import device_pipeline as DP  # noqa: E402
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
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    k_alt = int(sys.argv[2]) if len(sys.argv) > 2 else 64
    import jax.numpy as jnp

    enc = FrameEncoder(12, 2, SR, 16, xp=jnp)
    variants = {"ladder": 0, f"K={k_alt}": k_alt}
    ref_bytes = {}
    for name, k in variants.items():
        DP.CHUNK_BLOCKS = k
        t0 = time.time()
        ref_bytes[name] = enc.encode(*corpus(1))
        print(f"warm {name}: {time.time() - t0:.1f}s", flush=True)
    assert len(set(ref_bytes.values())) == 1, "chunk width changed the bytes!"

    times = {v: [] for v in variants}
    seed = 500
    names = list(variants)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            DP.CHUNK_BLOCKS = variants[name]
            left, right = corpus(seed)
            seed += 1
            t0 = time.perf_counter()
            enc.encode(left, right)
            times[name].append(time.perf_counter() - t0)
    for name in names:
        ts = sorted(times[name])
        print(f"{name}: best {ts[0]*1e3:.1f} ms  median {ts[len(ts)//2]*1e3:.1f} ms "
              f"(best {FRAMES/ts[0]/1e6:.2f} M fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
