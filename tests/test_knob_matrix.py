"""Perf-routing knobs must never change bytes (VERDICT r4 #7).

One 9-full-block + tail fixture swept through the routing envelope —
upload buckets on/off x bucket grid, mesh on/off, the cold-start route,
the numpy backend, and a no-native subprocess — every combination must
produce the identical frame. Chunk-width variation (8/4) joins under
LAC_TPU_SLOW=1 (extra planner shapes cost CPU compile minutes).
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lac_tpu import device_pipeline as DP
from lac_tpu.encoder import FrameEncoder

REPO = pathlib.Path(__file__).resolve().parent.parent


def _signal():
    rng = np.random.RandomState(77)
    n = 9 * 16384 + 4321
    t = np.arange(n, dtype=np.float64)
    sig = np.sin(2 * np.pi * 440 * t / 44100) * 16000
    l = np.clip(sig + rng.standard_normal(n) * 400, -32768, 32767).astype(np.int32)
    r = np.clip(np.roll(sig, 17) * 0.8 + rng.standard_normal(n) * 200, -32768, 32767).astype(np.int32)
    return l, r


def _encode_jax(l, r):
    return FrameEncoder(12, 2, 44100, 16, xp=jnp).encode(l, r)


def test_knob_matrix_byte_invariant(tmp_path, monkeypatch):
    l, r = _signal()
    ref = FrameEncoder(12, 2, 44100, 16, xp=np).encode(l, r)  # numpy engine

    # device plane pipeline: upload-bucket x delta-upload knobs
    # (partial K=16 chunk; the 9-block signal engages 12/14-bit deltas)
    for buckets, div in (("1", "4"), ("1", "8"), ("0", "4")):
        monkeypatch.setenv("LAC_TPU_UPLOAD_BUCKETS", buckets)
        monkeypatch.setenv("LAC_TPU_UPLOAD_BUCKET_DIV", div)
        for delta in ("0", "1"):
            monkeypatch.setenv("LAC_TPU_UPLOAD_DELTA", delta)
            assert _encode_jax(l, r) == ref, f"buckets={buckets} div={div} delta={delta}"
    monkeypatch.delenv("LAC_TPU_UPLOAD_BUCKETS", raising=False)
    monkeypatch.delenv("LAC_TPU_UPLOAD_BUCKET_DIV", raising=False)
    monkeypatch.delenv("LAC_TPU_UPLOAD_DELTA", raising=False)

    # sharded over the default mesh (buckets become full-K host pads)
    if len(jax.devices()) >= 8:
        from lac_tpu.parallel import make_mesh

        enc = FrameEncoder(12, 2, 44100, 16, xp=jnp, mesh=make_mesh(jax.devices()[:8]))
        assert enc.encode(l, r) == ref, "mesh"

    # cold-start route (accelerator-looking env, cold process, short
    # input -> the native host planner takes over; encoder.py:41-72)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "9999")
    monkeypatch.setattr(DP, "_PROC_WARM", False)
    from lac_tpu.runtime.native import native_available

    if native_available():
        from lac_tpu.encoder import _cold_route

        assert _cold_route(10), "cold route must engage under this env"
        assert _encode_jax(l, r) == ref, "cold route"
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(DP, "_PROC_WARM", True)

    # chunk widths beyond the pinned 16 (new planner shapes: slow lane)
    if os.environ.get("LAC_TPU_SLOW") == "1":
        for chunk in (8, 4):
            monkeypatch.setattr(DP, "CHUNK_BLOCKS", chunk)
            assert _encode_jax(l, r) == ref, f"chunk={chunk}"

    (tmp_path / "want.lac").write_bytes(ref)
    np.save(tmp_path / "l.npy", l)
    np.save(tmp_path / "r.npy", r)
    script = (
        "import sys, pathlib\n"
        "import numpy as np\n"
        "sys.path.insert(0, sys.argv[1])\n"
        "from lac_tpu.runtime.native import native_available\n"
        "assert not native_available()\n"
        "from lac_tpu.encoder import FrameEncoder\n"
        "d = pathlib.Path(sys.argv[2])\n"
        "l, r = np.load(d / 'l.npy'), np.load(d / 'r.npy')\n"
        "got = FrameEncoder(12, 2, 44100, 16).encode(l, r)\n"
        "assert got == (d / 'want.lac').read_bytes(), 'no-native diverged'\n"
        "print('ok')\n"
    )
    env = dict(os.environ, LAC_TPU_NO_NATIVE="1", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", script, str(REPO), str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert res.returncode == 0, res.stderr[-2000:]
