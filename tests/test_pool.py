"""Cross-file chunk pooling (lac_tpu/pool.py): pooled device waves must
produce byte-identical frames to per-file encodes (blocks are
file-agnostic once planes are cut), the serve prescreen must route
exactly, and the pooled serve path must match the one-shot CLI."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from lac_tpu.encoder import FrameEncoder
from lac_tpu.io.wav import write_wav
from lac_tpu.pool import encode_pooled, prepare_encode_job, split_waves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16384


def _mix(frames, seed):
    """Stereo content whose per-block character alternates (correlated /
    independent / borderline) so pooled waves hit MS, LR, and the
    uncertain probe path."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64)
    sig = (9000 * np.sin(2 * np.pi * 440 * t / 44100)).astype(np.int64)
    left = np.clip(sig + rng.randint(-2000, 2000, frames), -32768, 32767)
    right = np.empty(frames, np.int64)
    for b0 in range(0, frames, B):
        b1 = min(b0 + B, frames)
        m = (b0 // B) % 3
        if m == 0:
            right[b0:b1] = left[b0:b1] // 2 + rng.randint(-100, 100, b1 - b0)
        elif m == 1:
            right[b0:b1] = rng.randint(-9000, 9000, b1 - b0)
        else:
            right[b0:b1] = (left[b0:b1] * 0.82).astype(np.int64) + rng.randint(
                -2500, 2500, b1 - b0
            )
    return left.astype(np.int32), np.clip(right, -32768, 32767).astype(np.int32)


def test_encode_pooled_matches_per_file_stereo_auto():
    # lengths mix tails, exact block multiples, and sub-chunk files; the
    # pinned LAC_TPU_CHUNK_BLOCKS=16 means the 10 combined full blocks
    # share chunks across file boundaries
    items = [
        _mix(3 * B + 1000, 1),
        _mix(2 * B, 2),
        _mix(B + 77, 3),
        _mix(4 * B + B // 2, 4),
    ]
    pooled = encode_pooled(items, 44100, 16, stereo_mode=2, xp=jnp)
    for i, ((l, r), got) in enumerate(zip(items, pooled)):
        enc = FrameEncoder(12, 2, 44100, 16, xp=jnp)
        assert got == enc.encode(l, r), f"pooled frame {i} diverged"


def test_encode_pooled_mixed_kinds_and_depth():
    # mono and stereo items pool into separate waves; 24-bit uses the
    # int32 plane dtype and the 5-limb analyze executable
    l0, r0 = _mix(2 * B + 500, 11)
    l1 = _mix(3 * B, 12)[0]
    items16 = [(l0, r0), (l1, None)]
    pooled = encode_pooled(items16, 44100, 16, stereo_mode=1, xp=jnp)
    assert pooled[0] == FrameEncoder(12, 1, 44100, 16, xp=jnp).encode(l0, r0)
    assert pooled[1] == FrameEncoder(12, 0, 44100, 16, xp=jnp).encode(l1)

    rng = np.random.RandomState(13)
    l24 = rng.randint(-(1 << 22), 1 << 22, 2 * B + 9).astype(np.int32)
    r24 = (l24 // 3 + rng.randint(-(1 << 12), 1 << 12, 2 * B + 9)).astype(np.int32)
    got = encode_pooled([(l24, r24)], 96000, 24, stereo_mode=2, xp=jnp)[0]
    assert got == FrameEncoder(12, 2, 96000, 24, xp=jnp).encode(l24, r24)


def test_encode_pooled_numpy_backend_falls_back():
    l, r = _mix(B + 50, 21)
    got = encode_pooled([(l, r)], 44100, 16, stereo_mode=2, xp=np)
    assert got[0] == FrameEncoder(12, 2, 44100, 16, xp=np).encode(l, r)


def test_split_waves_bounds_blocks():
    class J:
        def __init__(self, n):
            self.nfull = n

    assert [len(w) for w in split_waves([J(3), J(3), J(3)], max_blocks=5)] == [1, 1, 1]
    assert [len(w) for w in split_waves([J(2), J(2), J(2)], max_blocks=4)] == [2, 1]
    # an oversize single file still forms its own wave
    assert [len(w) for w in split_waves([J(10)], max_blocks=4)] == [1]


def test_prepare_encode_job_prescreen(tmp_path, monkeypatch):
    monkeypatch.setenv("LAC_TPU_BACKEND", "jax")
    l, r = _mix(B + 200, 31)
    wav = str(tmp_path / "p.wav")
    assert write_wav(wav, l, r, 2, 48000, 16)
    out = str(tmp_path / "p.lac")

    prep = prepare_encode_job(["encode", wav, out])
    assert prep is not None
    assert prep.kind == "auto" and prep.nfull == 1 and prep.dt == np.int16
    assert prep.key == ("auto", np.dtype(np.int16).str, True)

    ms = prepare_encode_job(["encode", wav, out, "--stereo-mode=ms", "--no-partitioning"])
    assert ms is not None and ms.kind == "ms" and ms.key[2] is False

    # debug flags, parse errors, missing input, same path -> fallback
    assert prepare_encode_job(["encode", wav, out, "--debug-zr"]) is None
    # --debug-threads counts this job's own emission workers; a shared
    # wave would perturb the reported count -> one-shot path
    assert prepare_encode_job(["encode", wav, out, "--debug-threads"]) is None
    assert prepare_encode_job(["encode", wav, out, "--bogus"]) is None
    assert prepare_encode_job(["encode", str(tmp_path / "nope.wav"), out]) is None
    assert prepare_encode_job(["encode", wav, wav]) is None
    # a streaming-route file must be rejected from the WAV SCAN alone,
    # never materialized whole first (that is the spike the streaming
    # route exists to prevent)
    monkeypatch.setenv("LAC_TPU_STREAM_BLOCKS", "1")

    def _boom(path):  # read_wav must not be reached
        raise AssertionError("streaming-route prescreen read the whole WAV")

    import lac_tpu.io as lio

    monkeypatch.setattr(lio, "read_wav", _boom)
    assert prepare_encode_job(["encode", wav, out]) is None
    monkeypatch.undo()
    monkeypatch.setenv("LAC_TPU_BACKEND", "jax")
    # numpy backend -> fallback
    monkeypatch.setenv("LAC_TPU_BACKEND", "numpy")
    assert prepare_encode_job(["encode", wav, out]) is None
    # a sub-block file has no full blocks to pool
    monkeypatch.setenv("LAC_TPU_BACKEND", "jax")
    tiny = str(tmp_path / "tiny.wav")
    assert write_wav(tiny, l[:5000], r[:5000], 2, 48000, 16)
    assert prepare_encode_job(["encode", tiny, out]) is None


def test_serve_pooled_matches_cli(tmp_path):
    """Three queued encodes pool into one wave inside a --workers=2
    serve process (LAC_TPU_BACKEND=jax on CPU); bytes must equal the
    one-shot CLI's, and a decode round-trips."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["LAC_TPU_BACKEND"] = "jax"

    wavs, outs = [], []
    for i in range(3):
        l, r = _mix(2 * B + 321 * i, 50 + i)
        w = str(tmp_path / f"s{i}.wav")
        assert write_wav(w, l, r, 2, 44100, 16)
        wavs.append(w)
        outs.append(str(tmp_path / f"s{i}.lac"))

    lines = [f"encode {w} {o}" for w, o in zip(wavs, outs)]
    lines += ["wait", f"decode {outs[0]} {tmp_path / 'back.wav'}", "quit"]
    p = subprocess.run(
        [sys.executable, "-m", "lac_tpu.serve", "--workers=2"],
        input="".join(ln + "\n" for ln in lines),
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO,
    )
    assert p.returncode == 0, p.stderr
    res = [json.loads(ln) for ln in p.stdout.splitlines() if ln.strip()]
    by_id = {r["id"]: r for r in res}
    for i in range(1, 4):
        assert by_id[i]["ok"], by_id[i]
        assert by_id[i]["message"].startswith("Encoded ")
    assert by_id[4]["ok"] and by_id[4]["drained"] == 3
    assert by_id[5]["ok"]

    # bytes equal the one-shot CLI (numpy backend — parity regardless)
    for w, o in zip(wavs, outs):
        cli_out = o + ".cli"
        q = subprocess.run(
            [sys.executable, "-m", "lac_tpu.cli", "encode", w, cli_out],
            capture_output=True, text=True, env=dict(os.environ), cwd=REPO,
        )
        assert q.returncode == 0, q.stderr
        assert open(o, "rb").read() == open(cli_out, "rb").read()
    assert open(tmp_path / "back.wav", "rb").read() == open(wavs[0], "rb").read()


def test_pool_batcher_requeue_fallback_and_drain(monkeypatch):
    """In-process _PoolBatcher scheduling contract: a drained batch
    whose pooled blocks exceed pool._MAX_WAVE_BLOCKS is split across
    loop passes with order preserved (prescreen-residency cap), jobs
    that can't pool take the per-job fallback, every accepted job is
    responded to exactly once, and drain() returns only after the
    responses are on the wire (the wait-fence guarantee)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import lac_tpu.pool as P
    import lac_tpu.serve as serve_mod

    monkeypatch.setattr(P, "_MAX_WAVE_BLOCKS", 2)

    gate = threading.Event()  # holds wave 0 so later submits pile up
    waves_run = []

    def fake_prepare(parts):
        if parts[1] == "fallback.wav":
            return None
        prep = P.PreparedEncode(
            parts=list(parts), in_path=parts[1], wav=None,
            kind="auto", nfull=1, dt=np.int16,
        )
        prep.key = ("auto", "<i2", True)
        return prep

    def fake_run_group_wave(group, file_done):
        if not waves_run:
            gate.wait(timeout=60)
        waves_run.append([g.in_path for g in group])
        for i in range(len(group)):
            file_done(i, ({}, {}, {}))

    monkeypatch.setattr(P, "prepare_encode_job", fake_prepare)
    monkeypatch.setattr(P, "run_group_wave", fake_run_group_wave)
    monkeypatch.setattr(serve_mod, "run_job",
                        lambda argv: (0, f"Encoded {argv[1]}", ""))

    responses, rlock = [], threading.Lock()

    def respond(obj):
        with rlock:
            responses.append(dict(obj))

    def handle(job_id, parts):  # ordinary per-job path (fallbacks)
        respond({"id": job_id, "ok": True, "message": "fallback"})

    pool = ThreadPoolExecutor(2)
    b = serve_mod._PoolBatcher(pool, handle, respond)
    try:
        b.submit(1, ["encode", "w1.wav", "o1"])
        # wait until the batcher thread is inside wave 0 (pending empty)
        for _ in range(600):
            with b.cv:
                if not b.pending and b.busy == 1:
                    break
            import time as _t
            _t.sleep(0.01)
        for jid, path in ((2, "w2.wav"), (3, "w3.wav"), (4, "fallback.wav"),
                          (5, "w5.wav"), (6, "w6.wav"), (7, "w7.wav")):
            b.submit(jid, ["encode", path, f"o{jid}"])
        gate.set()
        assert b.drain() == 7
        with rlock:
            got = {r["id"] for r in responses}
            n = len(responses)
        assert got == {1, 2, 3, 4, 5, 6, 7} and n == 7
        # wave 0 ran alone; the piled-up batch split at the 2-block cap
        # with submission order preserved across requeue passes
        assert waves_run[0] == ["w1.wav"]
        assert waves_run[1:] == [["w2.wav", "w3.wav"], ["w5.wav", "w6.wav"],
                                 ["w7.wav"]]
        assert any(r.get("message") == "fallback" for r in responses)
    finally:
        gate.set()
        b.close()
        pool.shutdown(wait=True)


def test_pool_batcher_failed_wave_is_counted_and_logged(monkeypatch, capsys):
    """A wave that raises mid-flight is logged with its traceback and
    counted; files it already released keep their pooled result, the
    rest are answered once each through the ordinary per-job path."""
    from concurrent.futures import ThreadPoolExecutor

    import lac_tpu.pool as P
    import lac_tpu.serve as serve_mod

    def fake_prepare(parts):
        prep = P.PreparedEncode(
            parts=list(parts), in_path=parts[1], wav=None,
            kind="auto", nfull=1, dt=np.int16,
        )
        prep.key = ("auto", "<i2", True)
        return prep

    def fake_run_group_wave(group, file_done):
        file_done(0, ({}, {}, {}))
        raise RuntimeError("device wave broke")

    monkeypatch.setattr(P, "prepare_encode_job", fake_prepare)
    monkeypatch.setattr(P, "run_group_wave", fake_run_group_wave)
    monkeypatch.setattr(serve_mod, "run_job",
                        lambda argv: (0, f"Encoded {argv[1]}", ""))

    responses = []

    def handle(job_id, parts):  # ordinary per-job path
        responses.append({"id": job_id, "message": "per-job"})

    pool = ThreadPoolExecutor(2)
    b = serve_mod._PoolBatcher(pool, handle, responses.append)
    try:
        with b.cv:  # queue all three before the batcher thread sees any
            for jid in (1, 2, 3):
                b.busy += 1
                b.fenced += 1
                b.pending.append((jid, ["encode", f"w{jid}.wav", f"o{jid}"], 0.0))
            b.cv.notify_all()
        assert b.drain() == 3
        by_id = {r["id"]: r for r in responses}
        assert len(responses) == 3 and set(by_id) == {1, 2, 3}
        assert by_id[1]["message"] == "Encoded w1.wav"  # released before the fault
        assert by_id[2]["message"] == by_id[3]["message"] == "per-job"
        assert (b.waves, b.failed_waves) == (1, 1)
        assert "device wave broke" in capsys.readouterr().err
    finally:
        b.close()
        pool.shutdown(wait=True)
