#!/usr/bin/env python
"""Interleaved A/B: cross-file chunk pooling vs per-file pipelines.

Measures the thing lac_tpu.pool exists for — many short files filling
K-wide device chunks together — without the serve-process warm-load
noise (`scripts/bench_serve.py` measures the end-to-end service,
executable loads included).

Protocol (CLAUDE.md measurement rules for this host):
- ONE process, everything warm before timing (a throwaway round runs
  both arms first);
- fresh signal content for every timed encode;
- arms interleaved per round: A = batch.encode_batch(pooled=True),
  B = one FrameEncoder.encode per file; best-of-N reported;
- a final untimed round runs BOTH arms on the SAME items and
  byte-compares frame-for-frame (parity gate).

Usage: python scripts/bench_pool_ab.py [N_FILES] [ROUNDS]
Defaults: 16 files x 30 s, 3 rounds. Prints one JSON line.
"""

import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SR = 44100
SECONDS = 30
FRAMES = SR * SECONDS


def make_items(n, seed0):
    items = []
    for i in range(n):
        rng = np.random.RandomState(seed0 + i)
        t = np.arange(FRAMES, dtype=np.float64)
        sig = np.zeros(FRAMES)
        for _ in range(3):
            f = rng.uniform(80, 4000)
            sig += rng.uniform(2000, 9000) * np.sin(
                2 * np.pi * f * t / SR + rng.uniform(0, 6))
        left = np.clip(sig + rng.randint(-1500, 1500, FRAMES),
                       -32768, 32767).astype(np.int32)
        right = np.clip(sig * rng.uniform(0.4, 0.9)
                        + rng.randint(-800, 800, FRAMES),
                        -32768, 32767).astype(np.int32)
        items.append((left, right))
    return items


def main():
    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    import jax.numpy as jnp

    from lac_tpu.batch import encode_batch
    from lac_tpu.pool import encode_pooled

    def arm_pooled(items):
        return encode_pooled(items, SR, 16, stereo_mode=2, xp=jnp, max_workers=4)

    def arm_perfile(items):
        return encode_batch(items, SR, 16, stereo_mode=2, xp=jnp, max_workers=4)

    seed = 77000
    print("warmup (loads every executable once)...", file=sys.stderr)
    arm_pooled(make_items(2, seed)); seed += 100
    arm_perfile(make_items(2, seed)); seed += 100

    best = {"pooled": None, "perfile": None}
    for r in range(rounds):
        for name, arm in (("pooled", arm_pooled), ("perfile", arm_perfile)):
            items = make_items(n_files, seed); seed += 100
            t0 = time.perf_counter()
            frames = arm(items)
            dt = time.perf_counter() - t0
            assert len(frames) == n_files and all(len(f) > 0 for f in frames)
            fps = n_files * FRAMES / dt
            print(f"round {r} {name}: {dt:.2f} s = {fps/1e6:.2f} M frames/s",
                  file=sys.stderr)
            if best[name] is None or dt < best[name]:
                best[name] = dt

    # parity gate: same items through both arms, frame-for-frame equal
    items = make_items(n_files, seed)
    fa, fb = arm_pooled(items), arm_perfile(items)
    assert all(a == b for a, b in zip(fa, fb)), "pooled bytes diverge"

    agg = n_files * FRAMES
    print(json.dumps({
        "metric": "pool_ab_encode",
        "files": n_files, "seconds_per_file": SECONDS, "rounds": rounds,
        "pooled_best_s": round(best["pooled"], 2),
        "pooled_frames_per_s": round(agg / best["pooled"], 1),
        "perfile_best_s": round(best["perfile"], 2),
        "perfile_frames_per_s": round(agg / best["perfile"], 1),
        "pool_speedup": round(best["perfile"] / best["pooled"], 3),
        "parity": "frame-identical",
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
