"""Device-resident plane pipeline: byte parity with the legacy path.

The plane pipeline (lac_tpu/device_pipeline.py) reroutes the full-block
prefix of a jax-backend encode through on-device planes, stereo
decisions, probes, and gathered plan batches. Its only contract is
byte-identity: every frame must equal the numpy/legacy path (which the
rest of the suite pins to the reference binary).
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from lac_tpu.encoder import FrameEncoder
from lac_tpu import device_pipeline as DP
from lac_tpu.runtime.native import native_available

pytestmark = pytest.mark.skipif(
    not native_available(), reason="plane pipeline needs the native emitter"
)


def _signal(frames, seed, depth=16):
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64)
    sig = 0.4 * np.sin(2 * np.pi * 440 * t / 44100) + 0.2 * np.sin(2 * np.pi * 881 * t / 44100)
    sig += 0.06 * rng.standard_normal(frames)
    amp = 26000 if depth == 16 else 26000 * 256
    lim = 32768 if depth == 16 else 1 << 23
    l = np.clip(sig * amp, -lim, lim - 1).astype(np.int32)
    r = np.clip(np.roll(sig, 5) * amp * 0.7 + rng.standard_normal(frames) * amp * 0.02,
                -lim, lim - 1).astype(np.int32)
    return l, r


def _both(mode, depth, l, r=()):
    a = FrameEncoder(12, mode, 44100, depth, xp=jnp).encode(l, r)
    b = FrameEncoder(12, mode, 44100, depth, xp=np).encode(l, r)
    return a, b


def _gliding_corpus(frames, seed=0xC0DEC):
    """Music-like gliding sines with an amplitude envelope: produces a
    mix of certain-LR / certain-MS / uncertain (probe-resolved) blocks."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64) / 44100
    sig = np.zeros(frames)
    for f0, f1, amp in ((220, 440, 0.3), (880, 860, 0.2), (3520, 3300, 0.08)):
        freq = np.linspace(f0, f1, frames)
        sig += amp * np.sin(2 * np.pi * np.cumsum(freq) / 44100)
    noise = rng.standard_normal(frames)
    for _ in range(2):
        noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig += 0.05 * noise
    env = 0.5 * (1 + np.sin(2 * np.pi * 0.37 * t))
    l = np.clip(sig * env * 28000, -32768, 32767).astype(np.int32)
    r = np.clip(np.roll(sig, 7) * env * 26500, -32768, 32767).astype(np.int32)
    return l, r


def test_auto_stereo_with_tail_matches_legacy():
    l, r = _gliding_corpus(16384 * 9 + 5000)
    # the corpus must exercise both certain and uncertain blocks
    from lac_tpu.ops.stereo import estimate_stereo_mode

    lm = l[: 9 * 16384].reshape(9, 16384)
    rm = r[: 9 * 16384].reshape(9, 16384)
    _, un = estimate_stereo_mode(lm, rm, np.ones_like(lm, bool))
    assert 0 < un.sum() < 9, "corpus regressed: want a mix of certain/uncertain"
    a, b = _both(2, 16, l, r)
    assert a == b


def test_forced_modes_and_mono_match_legacy():
    l, r = _signal(16384 * 9, 4)  # exact multiple: no tail block
    for mode in (0, 1):
        a, b = _both(mode, 16, l, r)
        assert a == b
    a, b = _both(0, 16, l)
    assert a == b


def test_24bit_auto_matches_legacy():
    l, r = _signal(16384 * 8 + 100, 5, depth=24)
    a, b = _both(2, 24, l, r)
    assert a == b


def test_upload_buckets_toggle_parity(monkeypatch):
    """The bucketed partial-chunk upload (default) and the host-pad-to-K
    path (LAC_TPU_UPLOAD_BUCKETS=0) must produce identical bytes; the
    bucket ladder covers its edges."""
    assert DP._upload_bucket(1, 16, None) == 4
    assert DP._upload_bucket(9, 16, None) == 12
    assert DP._upload_bucket(13, 16, None) == 16
    assert DP._upload_bucket(16, 16, None) == 16
    assert DP._upload_bucket(3, 16, object()) == 16  # meshes keep full-K
    monkeypatch.setenv("LAC_TPU_UPLOAD_BUCKETS", "0")
    assert DP._upload_bucket(3, 16, None) == 16

    l, r = _signal(16384 * 9 + 777, 21)  # partial chunk (9 < K=16) + tail
    monkeypatch.delenv("LAC_TPU_UPLOAD_BUCKETS", raising=False)
    a, legacy = _both(2, 16, l, r)
    monkeypatch.setenv("LAC_TPU_UPLOAD_BUCKETS", "0")
    a0 = FrameEncoder(12, 2, 44100, 16, xp=jnp).encode(l, r)
    assert a == a0 == legacy


def test_applicability_gates():
    enc = FrameEncoder(12, 2, 44100, 16, xp=jnp)
    assert DP.applicable(enc, DP.MIN_FULL_BLOCKS)
    assert not DP.applicable(enc, DP.MIN_FULL_BLOCKS - 1)
    enc_np = FrameEncoder(12, 2, 44100, 16, xp=np)
    assert not DP.applicable(enc_np, 100)
    enc.mesh = object()  # any configured mesh routes through parallel.mesh
    assert not DP.applicable(enc, 100)


def test_chunk_width_ladder(monkeypatch):
    # env pin (the suite's conftest sets LAC_TPU_CHUNK_BLOCKS) wins
    monkeypatch.setattr(DP, "CHUNK_BLOCKS", 16)
    assert DP.chunk_width(10_000) == 16
    # unset -> ladder: small files use the small width, large the big one
    monkeypatch.setattr(DP, "CHUNK_BLOCKS", 0)
    assert DP.chunk_width(DP.MIN_FULL_BLOCKS) == DP.CHUNK_LADDER[0]
    assert DP.chunk_width(DP.CHUNK_LADDER[1] - 1) == DP.CHUNK_LADDER[0]
    assert DP.chunk_width(DP.CHUNK_LADDER[1]) == DP.CHUNK_LADDER[1]
    assert DP.chunk_width(10**6) == DP.CHUNK_LADDER[-1]


def test_plan_batches_widths():
    # doubling allowed only when 2K is itself a ladder shape
    K0, K1 = DP.CHUNK_LADDER[0], DP.CHUNK_LADDER[1]
    assert K1 == 2 * K0
    assert list(DP.plan_batches(K0, K0)) == [(0, K0, K0)]
    assert list(DP.plan_batches(K0 + 34, K0)) == [(0, K0 + 34, K1)]
    assert list(DP.plan_batches(2 * K0, K0)) == [(0, 2 * K0, K1)]
    assert list(DP.plan_batches(2 * K0 + 5, K0)) == [(0, K1, K1), (K1, 5, K0)]
    # every non-top rung doubles into the next one up...
    assert list(DP.plan_batches(2 * K1, K1)) == [(0, 2 * K1, 2 * K1)]
    # ...but at the top ladder width there is no doubled executable
    Kt = DP.CHUNK_LADDER[-1]
    assert list(DP.plan_batches(2 * Kt, Kt)) == [(0, Kt, Kt), (Kt, Kt, Kt)]
    # non-ladder widths (test pins) never double
    assert list(DP.plan_batches(40, 16)) == [(0, 16, 16), (16, 16, 16), (32, 8, 16)]


def test_doubled_plan_batch_matches_legacy(monkeypatch):
    # force the doubled-batch path under the CPU test pin: ladder (16, 32)
    # makes a 16-block stereo chunk (32 lanes) take one 32-wide dispatch
    monkeypatch.setattr(DP, "CHUNK_BLOCKS", 16)
    monkeypatch.setattr(DP, "CHUNK_LADDER", (16, 32))
    l, r = _gliding_corpus(16384 * 18 + 700)
    a, b = _both(2, 16, l, r)
    assert a == b
    for mode in (0, 1):
        a, b = _both(mode, 16, l, r)
        assert a == b


@pytest.mark.skipif(
    os.environ.get("LAC_TPU_SLOW") != "1",
    reason="production-shape compile smoke: tens of minutes on one CPU core "
    "(run with LAC_TPU_SLOW=1; on the GPU, `python chip_smoke.py` runs "
    "the production shapes against the native host bytes)",
)
def test_production_shape_parity(monkeypatch):
    # compile + run the real (128, 16384) chunk width once and assert
    # byte parity against the host path
    monkeypatch.setattr(DP, "CHUNK_BLOCKS", 128)
    l, r = _signal(16384 * 130, 77)
    a, b = _both(2, 16, l, r)
    assert a == b


def test_pack24_toggle_parity(monkeypatch):
    """24-bit byte-plane uploads (default) and whole-int32 uploads
    (LAC_TPU_UPLOAD_PACK24=0) must produce identical bytes; the unpack
    executable must sign-extend exactly (io/wav.py _sign_extend)."""
    # unit: device unpack inverts the host pack at the 24-bit extremes
    rng = np.random.RandomState(9)
    m = rng.randint(-(1 << 23), 1 << 23, (4, DP.N)).astype(np.int32)
    m[0, :4] = (-(1 << 23), (1 << 23) - 1, -1, 0)
    got = np.asarray(DP._jitted_unpack24(4, 6)(DP._pack24_host(m)))
    assert got.shape == (6, DP.N)
    assert np.array_equal(got[:4], m) and not got[4:].any()

    # default is backend-aware: off on CPU-JAX (no link to save),
    # on for accelerators; the env var forces either way
    assert not DP._pack24_enabled("int32", None)  # CPU backend here
    monkeypatch.setenv("LAC_TPU_UPLOAD_PACK24", "1")
    assert DP._pack24_enabled("int32", None)
    assert not DP._pack24_enabled("int16", None)
    assert not DP._pack24_enabled("int32", object())  # mesh keeps rows
    monkeypatch.setenv("LAC_TPU_UPLOAD_PACK24", "0")
    assert not DP._pack24_enabled("int32", None)

    # partial chunk (9 < K=16) + tail: bucket rung with fused pad
    l, r = _signal(16384 * 9 + 777, 23, depth=24)
    monkeypatch.setenv("LAC_TPU_UPLOAD_PACK24", "1")
    a, legacy = _both(2, 24, l, r)
    monkeypatch.setenv("LAC_TPU_UPLOAD_PACK24", "0")
    a0 = FrameEncoder(12, 2, 44100, 24, xp=jnp).encode(l, r)
    assert a == a0 == legacy
