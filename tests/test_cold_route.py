"""One-shot cold-start routing (encoder._cold_route).

Short inputs in a cold accelerator-backend process must take the native
host path (the reference CLI is millisecond-class one-shot,
main.cpp:600-709); warm processes, CPU-JAX processes, and long inputs
must keep the device path.
"""

import numpy as np

from lac_tpu import device_pipeline as dp
from lac_tpu import encoder as E
from lac_tpu.runtime.native import native_available


def test_cold_route_decision_matrix(monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setattr(dp, "_PROC_WARM", False)
    # cold + accelerator + short: route iff the native planner exists
    assert E._cold_route(10) == native_available()
    # above the default 256-block threshold: never route
    assert not E._cold_route(257)
    # threshold override and disable
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "1000")
    assert E._cold_route(257) == native_available()
    monkeypatch.setenv("LAC_TPU_COLD_BLOCKS", "0")
    assert not E._cold_route(10)
    monkeypatch.delenv("LAC_TPU_COLD_BLOCKS")
    # a warm process never routes
    monkeypatch.setattr(dp, "_PROC_WARM", True)
    assert not E._cold_route(10)
    monkeypatch.setattr(dp, "_PROC_WARM", False)
    # CPU-JAX (the test suite itself) never routes
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert not E._cold_route(10)
    monkeypatch.setenv("JAX_PLATFORMS", "cuda,cpu")
    assert not E._cold_route(10)


def test_cold_routed_encode_matches_host_bytes(monkeypatch):
    import jax.numpy as jnp

    monkeypatch.setenv("JAX_PLATFORMS", "cuda")  # pretend accelerator env
    monkeypatch.setattr(dp, "_PROC_WARM", False)
    rng = np.random.RandomState(3)
    n = 16384 * 2 + 777
    left = rng.randint(-3000, 3000, n).astype(np.int32)
    right = np.roll(left, 9)
    routed = E.FrameEncoder(12, 2, 44100, 16, xp=jnp).encode(left, right)
    host = E.FrameEncoder(12, 2, 44100, 16, xp=np).encode(left, right)
    assert routed == host
    assert not dp.process_warm()  # the routed encode must not touch jax
