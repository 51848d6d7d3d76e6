#!/usr/bin/env python
"""Many-file serving throughput through the warm-process service.

The reference is a one-shot CLI: every file pays a process launch. Our
device path pays backend start-up and executable loads once per process — hopeless one-shot,
amortized to zero in `lac_tpu.serve`. This measures that story
end-to-end: N fresh 30 s stereo WAVs encoded through ONE serve process
(wall-clocked after `warm`), then decoded back through the same process,
vs the reference CLI run once per file, byte-compared for parity on
every output (encodes vs the reference stream, decodes vs the input
WAV). With --workers>1 the serve batcher pools the encodes' full blocks
into shared device chunks (lac_tpu.pool).

Distinct content per file; run alone on the host (host timings are
sensitive to other load).

Usage:
    python scripts/bench_serve.py [N_FILES] [WORKERS]
Defaults: 8 files, 2 workers. Prints one JSON summary line.
"""

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
REF = ROOT / ".refbuild" / "lac_cli"

from lac_tpu.io.wav import write_wav  # noqa: E402

SR = 44100
SECONDS = 30
FRAMES = SR * SECONDS


def make_wav(path, seed):
    rng = np.random.RandomState(seed)
    t = np.arange(FRAMES, dtype=np.float64)
    sig = np.zeros(FRAMES)
    for _ in range(3):
        f = rng.uniform(80, 4000)
        sig += rng.uniform(2000, 9000) * np.sin(2 * np.pi * f * t / SR + rng.uniform(0, 6))
    noise = rng.randint(-1500, 1500, FRAMES)
    left = np.clip(sig + noise, -32768, 32767).astype(np.int32)
    right = np.clip(sig * rng.uniform(0.4, 0.9) + rng.randint(-800, 800, FRAMES),
                    -32768, 32767).astype(np.int32)
    assert write_wav(str(path), left, right, 2, SR, 16)


def main():
    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    workers = int(sys.argv[2]) if len(sys.argv) > 2 else 2
    with tempfile.TemporaryDirectory() as td:
        td = pathlib.Path(td)
        wavs = []
        for i in range(n_files):
            p = td / f"f{i}.wav"
            make_wav(p, 1000 + i)
            wavs.append(p)

        proc = subprocess.Popen(
            [sys.executable, "-m", "lac_tpu.serve", f"--workers={workers}"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1, cwd=str(ROOT),
        )

        def send(line):
            proc.stdin.write(line + "\n")
            proc.stdin.flush()

        def recv():
            return json.loads(proc.stdout.readline())

        t0 = time.perf_counter()
        send("warm 128")
        warm_res = recv()
        warm_s = time.perf_counter() - t0
        assert warm_res["ok"], warm_res

        t0 = time.perf_counter()
        for i, w in enumerate(wavs):
            send(f"encode {w} {td / f'f{i}.lac'}")
        results = [recv() for _ in wavs]
        wall = time.perf_counter() - t0
        assert all(r["ok"] for r in results), results

        # decode serving aggregate: the same N files back to WAV through
        # the same warm process (native v3 pool per job)
        t0 = time.perf_counter()
        for i in range(n_files):
            send(f"decode {td / f'f{i}.lac'} {td / f'd{i}.wav'}")
        dec_results = [recv() for _ in wavs]
        dec_wall = time.perf_counter() - t0
        send("quit")
        proc.stdin.close()
        proc.wait(timeout=60)
        assert all(r["ok"] for r in dec_results), dec_results
        for i, w in enumerate(wavs):
            assert (td / f"d{i}.wav").read_bytes() == w.read_bytes(), \
                f"decode mismatch on file {i}"

        # reference CLI, one process per file (its normal usage)
        t0 = time.perf_counter()
        for i, w in enumerate(wavs):
            r = subprocess.run([str(REF), "encode", str(w), str(td / f"r{i}.lac")],
                               capture_output=True)
            assert r.returncode == 0, r.stderr
        ref_wall = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(n_files):
            r = subprocess.run(
                [str(REF), "decode", str(td / f"r{i}.lac"), str(td / f"rd{i}.wav")],
                capture_output=True)
            assert r.returncode == 0, r.stderr
        ref_dec_wall = time.perf_counter() - t0

        for i in range(n_files):
            ours = (td / f"f{i}.lac").read_bytes()
            refs = (td / f"r{i}.lac").read_bytes()
            assert ours == refs, f"parity failure on file {i}"

        per_ms = sorted(r["ms"] for r in results)
        print(json.dumps({
            "metric": "serve_encode_throughput",
            "files": n_files, "workers": workers,
            "frames_per_file": FRAMES,
            "warm_s": round(warm_s, 1),
            "value": round(n_files * FRAMES / wall, 1),
            "unit": "frames/s",
            "wall_s": round(wall, 2),
            "ref_value": round(n_files * FRAMES / ref_wall, 1),
            "vs_ref": round(ref_wall / wall, 3),
            "per_file_ms_min": per_ms[0], "per_file_ms_max": per_ms[-1],
            "decode_value": round(n_files * FRAMES / dec_wall, 1),
            "decode_wall_s": round(dec_wall, 2),
            "decode_ref_value": round(n_files * FRAMES / ref_dec_wall, 1),
            "decode_vs_ref": round(ref_dec_wall / dec_wall, 3),
            "parity": "byte-identical",
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
