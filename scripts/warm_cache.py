#!/usr/bin/env python
"""Precompile the encoder's hot executables into the persistent XLA cache.

Run once after deployment (or a code change): compiles the planner for
the fixed hot shapes (16384-sample blocks, 256-sample probes) across the
power-of-two batch buckets, plus the autocorrelation kernel. First
compiles take a while; every later process loads from the persistent
compile cache (JAX_COMPILATION_CACHE_DIR, else .cache/jax in the
checkout).
"""

import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402

import lac_tpu  # noqa: E402

lac_tpu.configure_jax()

import jax  # noqa: E402

from lac_tpu.format import constants as C  # noqa: E402
from lac_tpu import encoder as E  # noqa: E402


def warm(n, buckets, emit_fields, dtype=np.int16):
    for b in buckets:
        t0 = time.time()
        pcm = np.zeros((b, n), dtype)
        coeffs = np.zeros((5, b, 13), np.int16)
        valid = np.zeros((5, b), bool)
        fn = E._jitted_plan(n, True, True, emit_fields)
        jax.block_until_ready(fn(jax.device_put(pcm), jax.device_put(coeffs), jax.device_put(valid))["meta"])
        print(f"plan n={n} B={b} emit={emit_fields} {np.dtype(dtype).name}: {time.time() - t0:.1f}s", flush=True)


def warm_planes():
    """Plane-pipeline executables (device_pipeline): analyze per stereo
    kind/dtype/ladder width, the row gathers, and the plan batch shapes."""
    from lac_tpu import device_pipeline as DP

    widths = (DP.CHUNK_BLOCKS,) if DP.CHUNK_BLOCKS else DP.CHUNK_LADDER
    for K in widths:
        rowsK = jax.device_put(np.zeros(K, np.int32))
        for kind in ("auto", "lr", "ms", "mono"):
            for dt in (np.int16, np.int32):
                t0 = time.time()
                lmat = jax.device_put(np.zeros((K, DP.N), dt))
                out = DP._jitted_analyze(K, kind, str(np.dtype(dt)), None)(lmat, lmat)
                jax.block_until_ready(out.get("hostbuf", out.get("lags")))
                g = DP._jitted_gather(DP.N)(out["planes"], rowsK)
                jax.block_until_ready(g)
                if kind == "auto":
                    probe_rows = jax.device_put(np.zeros(12 * K, np.int32))
                    jax.block_until_ready(DP._jitted_gather(DP.PROBE)(out["probes"], probe_rows))
                print(f"analyze K={K} kind={kind} dtype={np.dtype(dt).name}: {time.time() - t0:.1f}s", flush=True)


def warm_pads():
    """Partial-chunk upload-bucket pad executables (device_pipeline
    _jitted_padrows), one per (bucket, K, dtype), plus the fused 24-bit
    pad+unpack executables when pack24 is on for this backend. The step
    MUST come from the shared env-derived grid (DP._bucket_step honors
    LAC_TPU_UPLOAD_BUCKET_DIV) or the warmed shapes miss what a real
    partial chunk requests."""
    from lac_tpu import device_pipeline as DP

    widths = (DP.CHUNK_BLOCKS,) if DP.CHUNK_BLOCKS else DP.CHUNK_LADDER
    t0 = time.time()
    for K in widths:
        step = DP._bucket_step(K)
        for b in range(step, K, step):
            for dt in (np.int16, np.int32):
                jax.block_until_ready(DP._jitted_padrows(b, K, str(np.dtype(dt)))(
                    jax.device_put(np.zeros((b, DP.N), dt))))
        if DP._pack24_enabled("int32", None):
            for b in (*range(step, K, step), K):
                jax.block_until_ready(DP._jitted_unpack24(b, K)(
                    jax.device_put(np.zeros((3, b, DP.N), np.uint8))))
    print(f"upload-bucket pads: {time.time() - t0:.1f}s", flush=True)


def main():
    t0 = time.time()
    # limb variants: 4 limbs for int16 uploads, 5 for in-domain int32
    # (the group path's buckets, encoder._GroupJob.dispatch_autocorr)
    for nl, dt in ((4, np.int16), (5, np.int32)):
        ac = E._jitted_autocorr(12, nl)
        for b in (1, 2, 4, 8, 16, 32, 64, 128):
            jax.block_until_ready(ac(jax.device_put(np.zeros((b, C.MAX_BLOCK_SIZE), dt))))
    print(f"autocorr buckets: {time.time() - t0:.1f}s", flush=True)
    from lac_tpu.runtime.native import native_available

    emit_fields = not native_available()
    warm_planes()
    warm_pads()
    # plane-pipeline plan shapes (int32 gathered rows, fixed batches)
    from lac_tpu import device_pipeline as DP

    widths = (DP.CHUNK_BLOCKS,) if DP.CHUNK_BLOCKS else DP.CHUNK_LADDER
    warm(C.MAX_BLOCK_SIZE, widths, emit_fields, np.int32)
    warm(C.STEREO_PROBE_SIZE, tuple(12 * K for K in widths), emit_fields, np.int32)
    # legacy group-path buckets (int16 when content fits, else int32)
    warm(C.MAX_BLOCK_SIZE, (1, 2, 4, 8, 16, 32, 64, 128), emit_fields)
    warm(C.STEREO_PROBE_SIZE, (16, 64, 256, 1024), emit_fields)
    # the driver's __graft_entry__.entry() compile-check shape: (8, 4096)
    # WITH emission fields — not hit by any product path above
    t0 = time.time()
    import __graft_entry__ as g

    fn, args = g.entry()
    jax.block_until_ready(jax.jit(fn)(*(jax.device_put(a) for a in args))["meta"])
    print(f"entry() shape: {time.time() - t0:.1f}s", flush=True)
    print("cache warm.")


if __name__ == "__main__":
    main()
