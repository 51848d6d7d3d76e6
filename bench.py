"""Benchmark: warm device-path .lac encode throughput vs the reference encoder.

Prints one JSON line after the headline measurement:
    {"metric": "encode_throughput", "value": <frames/s>, "unit": "frames/s",
     "vs_baseline": <ours / reference-CPU>, "device": {...}}
then (wall-clock budget permitting, env LAC_BENCH_BUDGET_S, default 540)
re-emits it enriched with long-file and decode fields after each stage,
so a stage that overruns the budget never loses an earlier number.

The corpus is deterministic music-like stereo audio (sum of gliding
sines + filtered noise, 44.1 kHz / 16-bit). The reference baseline is
measured live when `.refbuild/lac_cli` exists, else read from
`bench_baseline.json` (recorded on a reference CPU host).

The device path runs in this process and needs an accelerator: with
none, or when the device path fails, the benchmark exits nonzero with
the error instead of measuring a host fallback. Every line names the
device it ran on.

Correctness gate: our bitstream must be byte-identical to the
reference's (when the binary is present).
"""

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
REF = ROOT / ".refbuild" / "lac_cli"
BASELINE_FILE = ROOT / "bench_baseline.json"

SECONDS = 30
SR = 44100
FRAMES = SR * SECONDS

T0 = time.monotonic()
BUDGET_S = float(os.environ.get("LAC_BENCH_BUDGET_S", "540"))

# the benchmark measures the warm serving path: disable the one-shot
# cold-start routing that would otherwise send the 30 s corpus to the
# native host planner in a cold process (see encoder._cold_route)
os.environ.setdefault("LAC_TPU_COLD_BLOCKS", "0")


def remaining():
    return BUDGET_S - (time.monotonic() - T0)


def make_corpus():
    rng = np.random.RandomState(0xC0DEC)
    t = np.arange(FRAMES, dtype=np.float64) / SR
    sig = np.zeros(FRAMES)
    for f0, f1, amp in ((220, 440, 0.3), (880, 860, 0.2), (3520, 3300, 0.08)):
        freq = np.linspace(f0, f1, FRAMES)
        sig += amp * np.sin(2 * np.pi * np.cumsum(freq) / SR)
    noise = rng.standard_normal(FRAMES)
    # crude lowpass: cumulative moving blend
    for _ in range(2):
        noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig += 0.05 * noise
    env = 0.5 * (1 + np.sin(2 * np.pi * 0.37 * t))
    left = np.clip(sig * env * 28000, -32768, 32767).astype(np.int32)
    right = np.clip(np.roll(sig, 7) * env * 26500, -32768, 32767).astype(np.int32)
    return left, right


LONG_FRAMES = 50_000_000


def make_long(seed=52, frames=LONG_FRAMES):
    """Music-like stereo content (the long-file scaling case)."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64)
    sig = 0.4 * np.sin(2 * np.pi * 440 * t / SR) + 0.2 * np.sin(2 * np.pi * 881 * t / SR)
    noise = rng.standard_normal(frames)
    noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig += 0.06 * noise
    left = np.clip(sig * 26000, -32768, 32767).astype(np.int32)
    right = np.clip(np.roll(sig, 5) * 25000, -32768, 32767).astype(np.int32)
    return left, right


def device_info():
    """The accelerator this process measures on; raises without one."""
    import lac_tpu

    lac_tpu.configure_jax()
    import jax

    if jax.default_backend() == "cpu":
        raise RuntimeError("no accelerator: the benchmark measures the device path only")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def bench_ours(left, right, repeats=10):
    import jax.numpy as jnp

    from lac_tpu.encoder import FrameEncoder

    enc = FrameEncoder(12, 2, SR, 16, xp=jnp)
    bitstream = enc.encode(left, right)  # warmup (compilation / executable load)
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        enc.encode(left, right)
        best = min(best, time.perf_counter() - t0)
        if i >= 1 and remaining() < 0.3 * BUDGET_S:
            break
    return enc, bitstream, FRAMES / best


def bench_reference(left, right):
    if not REF.exists():
        return None, None
    from lac_tpu.io import write_wav

    with tempfile.TemporaryDirectory() as td:
        wav = f"{td}/bench.wav"
        lac = f"{td}/bench.lac"
        write_wav(wav, left, right, 2, SR, 16)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            subprocess.run([str(REF), "encode", wav, lac], check=True, capture_output=True)
            best = min(best, time.perf_counter() - t0)
        data = open(lac, "rb").read()
    return data, FRAMES / best


def bench_long(enc, frames):
    """-> (ours frames/s, reference frames/s or None, parity ok or None).
    One warm pass at the long-ladder (K=256) width, then one timed pass;
    the reference is timed on the same content when the budget allows."""
    enc.encode(*make_long(51, frames=16384 * 300))
    left, right = make_long(52, frames=frames)
    t0 = time.perf_counter()
    bs = enc.encode(left, right)
    ours_fps = frames / (time.perf_counter() - t0)
    if not REF.exists() or remaining() < 90:
        return ours_fps, None, None
    from lac_tpu.io import write_wav

    with tempfile.TemporaryDirectory() as td:
        wav = f"{td}/long.wav"
        lac = f"{td}/long.lac"
        write_wav(wav, left, right, 2, SR, 16)
        t0 = time.perf_counter()
        subprocess.run([str(REF), "encode", wav, lac], check=True, capture_output=True)
        ref_fps = frames / (time.perf_counter() - t0)
        parity = open(lac, "rb").read() == bs
    return ours_fps, ref_fps, parity


def bench_decode(bitstream):
    """Decode throughput on the 30 s corpus (full .lac -> on-disk WAV,
    native v3 streaming path), best of 3."""
    from lac_tpu.decoder import FrameDecoder

    dec = FrameDecoder()
    with tempfile.TemporaryDirectory() as td:
        out = f"{td}/dec.wav"
        dec.decode_to_wav(bitstream, out)  # warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            dec.decode_to_wav(bitstream, out)
            best = min(best, time.perf_counter() - t0)
    return FRAMES / best


def emit(result):
    print(json.dumps(result), flush=True)


def main():
    device = device_info()
    left, right = make_corpus()
    ref_bytes, ref_fps = bench_reference(left, right)
    if ref_fps is None:
        ref_fps = json.loads(BASELINE_FILE.read_text())["reference_frames_per_s"]

    enc, bitstream, ours_fps = bench_ours(left, right)
    if ref_bytes is not None and ref_bytes != bitstream:
        raise RuntimeError("bitstream parity FAILED against the reference encoder")
    result = {
        "metric": "encode_throughput",
        "value": round(ours_fps, 1),
        "unit": "frames/s",
        "vs_baseline": round(ours_fps / ref_fps, 3),
        "realtime_x": round(ours_fps / SR, 1),
        "device": device,
    }
    emit(result)  # headline: lands before any optional extras

    if os.environ.get("LAC_BENCH_SKIP_LONG") != "1" and remaining() > 120:
        frames = LONG_FRAMES if remaining() > 280 else 16384 * 1024
        long_fps, long_ref, long_parity = bench_long(enc, frames)
        result["long_frames"] = frames
        result["long_value"] = round(long_fps, 1)
        if long_ref:
            result["long_vs_baseline"] = round(long_fps / long_ref, 3)
        if long_parity is False:
            raise RuntimeError("long-file bitstream parity FAILED against the reference encoder")
        emit(result)
    if os.environ.get("LAC_BENCH_SKIP_DECODE") != "1" and remaining() > 40:
        result["decode_value"] = round(bench_decode(bitstream), 1)
        emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
