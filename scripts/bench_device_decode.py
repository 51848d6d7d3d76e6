"""Measure the device decode backend vs the native decoder on a batch.

Round-2 verdict item 5: demonstrate a scenario where
``FrameDecoder(backend="device")`` wins, or record honestly that it
does not on this hardware. Decodes the same set of encoded streams
with both backends (warm process, fresh decode objects per pass) and
prints the per-backend wall time; output parity is asserted.

Run on the GPU:          python scripts/bench_device_decode.py
CPU smoke:               JAX_PLATFORMS=cpu FILES=2 FRAMES=200000 python ...
"""

import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

FILES = int(os.environ.get("FILES", "8"))
FRAMES = int(os.environ.get("FRAMES", str(16384 * 64)))


def make(seed):
    rng = np.random.RandomState(seed)
    t = np.arange(FRAMES, dtype=np.float64)
    sig = 0.5 * np.sin(2 * np.pi * (300 + 20 * seed) * t / 44100)
    noise = rng.standard_normal(FRAMES)
    sig += 0.05 * (0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]]))
    left = np.clip(sig * 24000, -32768, 32767).astype(np.int32)
    right = np.clip(np.roll(sig, 3) * 23000, -32768, 32767).astype(np.int32)
    return left, right


def main():
    from lac_tpu import configure_jax

    configure_jax()
    from lac_tpu.decoder import FrameDecoder
    from lac_tpu.encoder import FrameEncoder

    import jax.numpy as jnp

    enc = FrameEncoder(12, 2, 44100, 16, xp=jnp)
    streams, pcms = [], []
    for s in range(FILES):
        l, r = make(s)
        streams.append(enc.encode(l, r))
        pcms.append((l, r))
    total = FILES * FRAMES
    print(f"{FILES} files x {FRAMES} frames encoded "
          f"({sum(map(len, streams)) / 1e6:.1f} MB total)")

    results = {}
    for backend in ("native", "device"):
        dec = FrameDecoder(backend=backend)
        outs = [dec.decode(bs) for bs in streams]  # warm (compiles/loads)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            outs = [dec.decode(bs) for bs in streams]
            best = min(best, time.perf_counter() - t0)
        for (l, r), out in zip(pcms, outs):
            dl, dr = out[0], out[1]
            assert np.array_equal(np.asarray(dl, np.int32), l)
            assert np.array_equal(np.asarray(dr, np.int32), r)
        results[backend] = best
        print(f"{backend:>7}: {best * 1e3:8.1f} ms "
              f"({total / best / 1e6:6.1f} Mframes/s)")
    ratio = results["device"] / results["native"]
    print(f"device/native wall ratio: {ratio:.2f}x "
          f"({'device wins' if ratio < 1 else 'native wins'})")


if __name__ == "__main__":
    main()
