"""The warm-process service (lac_tpu/serve.py): protocol, parity with
the one-shot CLI, failure isolation, and concurrent workers."""

import json
import os
import subprocess
import sys

import numpy as np

from lac_tpu.io.wav import write_wav

from .signals import lcg_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16384
EMPTY = np.empty(0, np.int32)


def run_serve(lines, extra_args=(), timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.run(
        [sys.executable, "-m", "lac_tpu.serve", *extra_args],
        input="".join(line + "\n" for line in lines),
        capture_output=True, text=True, env=env, timeout=timeout, cwd=REPO,
    )
    assert p.returncode == 0, p.stderr
    return [json.loads(line) for line in p.stdout.splitlines() if line.strip()]


def test_serve_roundtrip_matches_cli(tmp_path):
    left = lcg_noise(B + 777, 12000, 3)
    right = lcg_noise(B + 777, 9000, 4)
    wav = str(tmp_path / "in.wav")
    assert write_wav(wav, left, right, 2, 48000, 16)
    out = str(tmp_path / "served.lac")
    back = str(tmp_path / "back.wav")

    res = run_serve([
        "ping",
        f"encode {wav} {out}",
        f"decode {out} {back}",
        "quit",
    ])
    assert len(res) == 3
    assert res[0] == {"id": 1, "ok": True, "pong": True}
    by_id = {r["id"]: r for r in res}
    assert by_id[2]["ok"] and by_id[2]["rc"] == 0
    assert by_id[2]["message"] == f"Encoded {wav} -> {out} ({os.path.getsize(out)} bytes)"
    assert by_id[3]["ok"] and "samples per channel" in by_id[3]["message"]
    assert by_id[2]["ms"] > 0

    # byte parity with the one-shot CLI
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    cli_out = str(tmp_path / "cli.lac")
    p = subprocess.run([sys.executable, "-m", "lac_tpu.cli", "encode", wav, cli_out],
                       capture_output=True, text=True, env=env, cwd=REPO)
    assert p.returncode == 0, p.stderr
    assert open(out, "rb").read() == open(cli_out, "rb").read()
    assert open(back, "rb").read() == open(wav, "rb").read()


def test_serve_failures_isolated(tmp_path):
    """A failing job reports its CLI error and later jobs still run;
    bad lines and unknown commands get protocol errors."""
    left = lcg_noise(4096, 5000, 9)
    wav = str(tmp_path / "ok.wav")
    assert write_wav(wav, left, EMPTY, 1, 44100, 16)
    out = str(tmp_path / "ok.lac")
    missing = str(tmp_path / "missing.wav")

    res = run_serve([
        f"encode {missing} {tmp_path / 'x.lac'}",
        "frobnicate",
        "encode onlyonearg",
        'encode "un terminated',
        f"encode {wav} {out}",
        "quit",
    ])
    by_id = {r["id"]: r for r in res}
    assert not by_id[1]["ok"] and by_id[1]["rc"] == 1
    assert f"Failed to read WAV: {missing}" in by_id[1]["error"]
    assert not by_id[2]["ok"] and "unknown command" in by_id[2]["error"]
    assert not by_id[3]["ok"] and "usage:" in by_id[3]["error"]
    assert not by_id[4]["ok"] and "bad line" in by_id[4]["error"]
    assert by_id[5]["ok"]
    assert os.path.getsize(out) > 0
    assert not os.path.exists(tmp_path / "x.lac")


def test_serve_concurrent_workers(tmp_path):
    lines = []
    wavs = []
    for i in range(4):
        left = lcg_noise(8192, 4000 + 321 * i, 40 + i)
        w = str(tmp_path / f"f{i}.wav")
        assert write_wav(w, left, EMPTY, 1, 44100, 16)
        wavs.append(w)
        lines.append(f"encode {w} {tmp_path / f'f{i}.lac'}")
    lines.append("quit")
    res = run_serve(lines, extra_args=["--workers=3"])
    assert sorted(r["id"] for r in res) == [1, 2, 3, 4]
    assert all(r["ok"] for r in res)
    for i in range(4):
        assert os.path.getsize(tmp_path / f"f{i}.lac") > 0


def test_serve_warm_and_flags(tmp_path):
    left = lcg_noise(6000, 3000, 77)
    right = lcg_noise(6000, 2500, 78)
    wav = str(tmp_path / "s.wav")
    assert write_wav(wav, left, right, 2, 44100, 16)
    out = str(tmp_path / "s.lac")
    res = run_serve([
        "warm 1",
        f"encode {wav} {out} --stereo-mode=ms --no-partitioning",
        "quit",
    ], extra_args=["--warm=1"])
    by_id = {r["id"]: r for r in res}
    assert by_id[0]["ok"] and by_id[0]["warmed_blocks"] == 1  # --warm=1 startup
    assert by_id[1]["ok"] and by_id[1]["warmed_blocks"] == 1
    assert by_id[2]["ok"]
    # the flags reached the encoder: bytes match a direct flagged encode
    from lac_tpu.encoder import FrameEncoder

    enc = FrameEncoder(12, 1, 44100, 16)
    enc.set_partitioning_enabled(False)
    assert open(out, "rb").read() == enc.encode(left, right)


def test_serve_wait_barrier(tmp_path):
    """`wait` fences concurrent workers so a piped encode->decode chain
    works with --workers>1."""
    left = lcg_noise(B + 10, 8000, 21)
    wav = str(tmp_path / "w.wav")
    assert write_wav(wav, left, EMPTY, 1, 44100, 16)
    out = str(tmp_path / "w.lac")
    back = str(tmp_path / "w.back.wav")
    res = run_serve([
        f"encode {wav} {out}",
        "wait",
        f"decode {out} {back}",
        "quit",
    ], extra_args=["--workers=4"])
    by_id = {r["id"]: r for r in res}
    assert by_id[1]["ok"]
    # CPU-JAX encodes take the numpy path, so no pooled wave runs
    assert by_id[2] == {"id": 2, "ok": True, "drained": 1, "waves": 0,
                        "failed_waves": 0}
    assert by_id[3]["ok"]
    assert open(back, "rb").read() == open(wav, "rb").read()


def test_serve_eof_is_quit(tmp_path):
    res = run_serve(["ping"])  # stream ends without an explicit quit
    assert res == [{"id": 1, "ok": True, "pong": True}]


def test_serve_sigterm_drains_and_exits_zero(tmp_path):
    import json as _json
    import signal

    left = lcg_noise(8192, 6000, 55)
    wav = str(tmp_path / "t.wav")
    assert write_wav(wav, left, EMPTY, 1, 44100, 16)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    p = subprocess.Popen(
        [sys.executable, "-m", "lac_tpu.serve"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        bufsize=1, env=env, cwd=REPO,
    )
    try:
        p.stdin.write(f"encode {wav} {tmp_path / 't.lac'}\n")
        p.stdin.flush()
        res = _json.loads(p.stdout.readline())
        assert res["ok"], res
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
    assert os.path.getsize(tmp_path / "t.lac") > 0


def test_run_job_library_capture():
    """run_job works outside the serve loop (plain redirect capture)."""
    from lac_tpu.serve import run_job

    rc, out, err = run_job(["decode", "/nonexistent.lac", "/tmp/x.wav"])
    assert rc == 1 and "Failed to read LAC file" in err and out == ""
