#!/usr/bin/env python
"""lac_tpu quickstart: every public surface in one runnable script.

Runs on any backend (CPU numpy fallback included):

    JAX_PLATFORMS=cpu python examples/quickstart.py [workdir]

On a GPU host, drop JAX_PLATFORMS to use the device planner, and run
`python scripts/warm_cache.py` once after install to precompile the hot
executables into the persistent cache.
"""

import os
import pathlib
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from lac_tpu.batch import decode_batch, encode_batch
from lac_tpu.decoder import DecodeError, FrameDecoder
from lac_tpu.encoder import FrameEncoder
from lac_tpu.io import read_wav, write_wav
from lac_tpu.stream import encode_wav_to_lac


def make_music(frames, sr=44100, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(frames) / sr
    sig = sum(a * np.sin(2 * np.pi * f * t)
              for f, a in ((220, 9000), (440, 6000), (1320, 1500)))
    left = np.clip(sig + rng.randint(-400, 400, frames), -32768, 32767).astype(np.int32)
    right = np.clip(sig * 0.8 + rng.randint(-300, 300, frames), -32768, 32767).astype(np.int32)
    return left, right


def main():
    workdir = pathlib.Path(sys.argv[1]) if len(sys.argv) > 1 else pathlib.Path(
        tempfile.mkdtemp(prefix="lac_tpu_demo_"))
    workdir.mkdir(parents=True, exist_ok=True)
    sr, frames = 44100, 44100 * 5
    left, right = make_music(frames)

    # 1. library encode/decode (stereo_mode 2 = per-block auto)
    enc = FrameEncoder(order=12, stereo_mode=2, sample_rate=sr, bit_depth=16)
    lac = enc.encode(left, right)
    dl, dr, hdr = FrameDecoder().decode(lac)
    assert np.array_equal(dl, left) and np.array_equal(dr, right)
    print(f"1. in-memory roundtrip: {frames*4} PCM bytes -> {len(lac)} .lac bytes "
          f"(ratio {frames*4/len(lac):.2f}x), v{hdr.version} {hdr.sample_rate} Hz")

    # 2. CLI roundtrip (same flags/messages as the reference lac_cli)
    wav, out, back = workdir / "in.wav", workdir / "out.lac", workdir / "back.wav"
    write_wav(str(wav), left, right, 2, sr, 16)
    from lac_tpu import cli

    assert cli.main(["encode", str(wav), str(out), "--stereo-mode=ms"]) == 0
    assert cli.main(["decode", str(out), str(back)]) == 0
    assert read_wav(str(back))[0].tolist() == left.tolist()
    print("2. CLI roundtrip: ok (staged atomic output, forced mid/side)")

    # 3. bounded-memory streaming encode (O(chunk) peak, same bytes)
    big = workdir / "stream.lac"
    nbytes = encode_wav_to_lac(str(wav), str(big), stereo_mode=2, chunk_blocks=2)
    assert nbytes == big.stat().st_size
    print(f"3. streaming encode: {nbytes} bytes, O(chunk) memory")

    # 4. random-access decode: only the blocks overlapping the range
    start, count = 2 * sr, sr // 2
    rl, rr, _ = FrameDecoder().decode_range(lac, start, count)
    assert np.array_equal(rl, left[start:start + count])
    print(f"4. decode_range: {count} frames from offset {start}, O(range) work")

    # 5. multi-file batch helpers
    pairs = [make_music(8192, seed=s) for s in (1, 2, 3)]
    frames_out = encode_batch(pairs, sr, 16, stereo_mode=2, max_workers=2)
    for (l0, r0), (dl0, dr0, _) in zip(pairs, decode_batch(frames_out)):
        assert np.array_equal(l0, dl0) and np.array_equal(r0, dr0)
    print(f"5. batch: {len(pairs)} files, {sum(map(len, frames_out))} total bytes")

    # 6. strict validation: corrupt streams are rejected, never garbage
    try:
        FrameDecoder().decode(lac[:200])
        raise AssertionError("unreachable")
    except DecodeError as e:
        print(f"6. canonical validation: truncated stream rejected ({e})")

    # 7. warm-process service for many files (same bytes as the CLI)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1]) + \
        os.pathsep + env.get("PYTHONPATH", "")
    served = workdir / "served.lac"
    proc = subprocess.run(
        [sys.executable, "-m", "lac_tpu.serve"],
        input=f"ping\nencode {wav} {served}\nquit\n",
        capture_output=True, text=True, env=env,
    )
    print("7. serve:", *proc.stdout.strip().splitlines(), sep="\n   ")
    print(f"\nartifacts in {workdir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
