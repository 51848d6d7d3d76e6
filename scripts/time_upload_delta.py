#!/usr/bin/env python
"""Same-session interleaved A/B of the delta-bitpacked 16-bit plane
upload (LAC_TPU_UPLOAD_DELTA) — wrapped int16 deltas packed to 8/12/14
bits, inverted exactly on device. Music-scale content takes the 14-bit
tier (-12.5% upload bytes); quieter content the 12/8-bit tiers
(-25/-50%). Byte savings convert into throughput only when the
pipeline is upload-bound.

Three content modes: the long-file bench shape (default; LONG_BLOCKS
full blocks), `--corpus` (the 30 s headline shape), and `--depth24`
(24-bit music-scale content: the delta24 16-bit tier at 2 B/sample vs
the pack24 byte-planes' 3 — the `off` arm still ships pack24, so the
A/B isolates exactly the delta24 routing).

Usage: python scripts/time_upload_delta.py [ROUNDS] [--corpus|--depth24]
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
from lac_tpu import device_pipeline as DP  # noqa: E402

SR = 44100
LONG_BLOCKS = 512  # 8.4 M frames: two K=256 chunks rule out edge effects


def content(seed, frames, depth=16):
    """Music-like: lands in the 14-bit delta tier like the bench long
    file at 16-bit (verified via DP._pack_delta_host on the first
    chunk); the same waveform at 24-bit scale lands in delta24's
    16-bit tier (2 B/sample vs pack24's 3)."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64)
    sig = 0.4 * np.sin(2 * np.pi * 440 * t / SR) + 0.2 * np.sin(2 * np.pi * 881 * t / SR)
    noise = rng.standard_normal(frames)
    noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig += 0.06 * noise
    lim = (1 << (depth - 1)) - 1
    # 24-bit arm: x64 = a 22-bit peak (typical mastering headroom).
    # Full-scale 24-bit content with this much HF energy overflows even
    # the 20-bit delta tier and falls back to pack24 (measured: the
    # fallback costs nothing); x64 lands in the 20-bit tier (2.5
    # B/sample vs pack24's 3).
    amp_l, amp_r = (26000, 25000) if depth == 16 else (26000 * 64, 25000 * 64)
    left = np.clip(sig * amp_l, -lim - 1, lim).astype(np.int32)
    right = np.clip(np.roll(sig, 5) * amp_r, -lim - 1, lim).astype(np.int32)
    return left, right


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    rounds = int(args[0]) if args else 5
    depth = 24 if "--depth24" in sys.argv else 16
    frames = SR * 30 if "--corpus" in sys.argv else LONG_BLOCKS * DP.N
    import jax.numpy as jnp

    l0, r0 = content(1, frames, depth)
    if depth == 24:
        b, _ = DP._pack_delta24_host(
            np.ascontiguousarray(l0[: 8 * DP.N].reshape(8, DP.N), np.int32))
    else:
        b, _ = DP._pack_delta_host(
            np.ascontiguousarray(l0[: 8 * DP.N].reshape(8, DP.N), np.int16))
    print(f"content delta tier: {b}-bit", file=sys.stderr)

    enc = FrameEncoder(12, 2, SR, depth, xp=jnp)
    variants = ("off", "on")

    def set_variant(v):
        os.environ["LAC_TPU_UPLOAD_DELTA"] = "1" if v == "on" else "0"

    for v in variants:  # warm both routes' executables
        set_variant(v)
        enc.encode(l0, r0)
    times = {v: [] for v in variants}
    seed = 100
    for r in range(rounds):
        order = variants if r % 2 == 0 else variants[::-1]
        for v in order:
            set_variant(v)
            left, right = content(seed, frames, depth)
            seed += 1
            t0 = time.perf_counter()
            enc.encode(left, right)
            times[v].append(time.perf_counter() - t0)
    for v in variants:
        ts = sorted(times[v])
        print(f"delta={v}: best {ts[0]*1e3:.1f} ms  median {ts[len(ts)//2]*1e3:.1f} ms "
              f"(best {frames/ts[0]/1e6:.2f} M fps)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
