#!/usr/bin/env python3
"""GPU smoke test: the encode path at production sizes, in one process.

    python chip_smoke.py              # one GPU: phases (a)-(e)
    python chip_smoke.py --devices 4  # four GPUs: the sharded paths only

Every phase drives the product's own entry points (``lac_tpu.cli.main``
and ``lac_tpu.serve.serve``) and checks the bytes against the native
host encode (``LAC_TPU_BACKEND=numpy``: the C++ planner and emitter the
golden fixtures pin), so a GPU run is correct exactly when it is
byte-identical to the host path:

(a) CLI encode + decode of three inputs (the 30 s bench corpus, a
    10-minute 44.1 kHz/16-bit file, a 2-minute 96 kHz/24-bit file);
(b) the CLI's bounded-memory streaming route (>= 2048 blocks);
(c) a warm ``serve --workers=2`` answering 8 encodes and 2 decodes;
(d) numerics at production width (256 x 16384): ``plan_group`` on the
    GPU vs numpy, the limb autocorrelation vs exact int64 lags, and the
    Triton scan kernels vs XLA's scans;
(e) time to first encode and warm encode rates (for the record only).

With ``--devices N`` only the multi-device checks run, on exactly N
GPUs: the sharded plane pipeline on the 10-minute file, and pooled
serving over the default mesh.

The script fails (nonzero exit, no final line) when JAX finds no GPU,
when the native runtime is missing, or when any phase fails. Its last
line on success is ``{"ok": true, "device": {...}}``.
"""

import argparse
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent

# a failed CUDA start must be an error, never a quiet CPU run: JAX then
# initializes the CUDA backend alone and raises when it cannot
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cuda" not in _platforms.split(","):
    sys.exit(f"chip_smoke.py runs on the GPU only (JAX_PLATFORMS={_platforms!r})")
os.environ["JAX_PLATFORMS"] = "cuda"
# every encode must take the device path, including short inputs in a
# cold process (encoder._cold_route would send them to the host)
os.environ["LAC_TPU_COLD_BLOCKS"] = "0"

import numpy as np  # noqa: E402

SR16, SR24 = 44100, 96000
N = 16384
PLATFORM = "gpu"
# input sizes: seconds of audio, blocks for the streamed file, rows for
# the numerics checks (production widths; a CPU rehearsal shrinks them)
LONG_S, HIRES_S, STREAM_BLOCKS, ROWS, SERVE_FILES = 600, 120, 2100, 256, 8


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------------ content


def music(frames, sr, amp, seed):
    """Seeded music-like stereo: two partials with a slow glide, lowpassed
    noise and a tremolo envelope; right is a delayed, scaled left."""
    rng = np.random.RandomState(seed)
    t = np.arange(frames, dtype=np.float64) / sr
    f = 220.0 + 40.0 * np.sin(2 * np.pi * 0.05 * t)
    sig = 0.5 * np.sin(2 * np.pi * np.cumsum(f) / sr) + 0.2 * np.sin(2 * np.pi * 1321.0 * t)
    noise = rng.standard_normal(frames)
    noise = 0.5 * noise + 0.5 * np.concatenate([[0.0], noise[:-1]])
    sig = (sig + 0.08 * noise) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.31 * t))
    lo, hi = -amp - 1, amp
    left = np.clip(sig * amp, lo, hi).astype(np.int32)
    right = np.clip(np.roll(sig, 9) * amp * 0.9, lo, hi).astype(np.int32)
    return left, right


def write_input(path, left, right, sr, depth):
    from lac_tpu.io import write_wav

    if not write_wav(str(path), left, right, 2, sr, depth):
        raise RuntimeError(f"could not write {path}")


# --------------------------------------------------------------- plumbing


class PlanSpy:
    """Counts plane-pipeline plan dispatches and checks that each one ran
    on the GPU (and, when ``want_devices`` > 1, sharded over that many)."""

    def __init__(self, want_devices=1):
        from lac_tpu import device_pipeline as DP

        self.DP = DP
        self.want = want_devices
        self.count = 0
        self.orig = DP._ChunkJob.dispatch_plan
        spy = self

        def dispatch_plan(job):
            spy.orig(job)
            meta = job.futs[0][0]["meta"]
            devs = meta.sharding.device_set
            if {d.platform for d in devs} != {PLATFORM} or len(devs) != spy.want:
                raise AssertionError(f"plan ran on {sorted(map(str, devs))}")
            spy.count += 1

        DP._ChunkJob.dispatch_plan = dispatch_plan

    def take(self):
        n, self.count = self.count, 0
        return n


def cli(*argv, backend=None):
    """Run the CLI in this process; returns (rc, seconds). Its success
    message is dropped; its error output passes through."""
    from contextlib import redirect_stdout

    from lac_tpu import cli as C

    prev = os.environ.pop("LAC_TPU_BACKEND", None)
    if backend:
        os.environ["LAC_TPU_BACKEND"] = backend
    try:
        t0 = time.perf_counter()
        with redirect_stdout(io.StringIO()):
            rc = C.main(list(argv))
        return rc, time.perf_counter() - t0
    finally:
        os.environ.pop("LAC_TPU_BACKEND", None)
        if prev is not None:
            os.environ["LAC_TPU_BACKEND"] = prev


def same_bytes(a, b):
    return pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()


def native_reference(wav, out):
    rc, sec = cli("encode", str(wav), str(out), backend="numpy")
    if rc != 0:
        raise RuntimeError(f"native host encode of {wav} failed")
    return sec


def clear_in_memory_executables():
    """Drop every compiled executable this process holds, so the next
    encode loads them from the persistent compile cache."""
    import jax

    from lac_tpu import device_pipeline as DP, encoder as E
    from lac_tpu.ops import pallas_kernels as PK
    from lac_tpu.parallel import mesh as M

    jax.clear_caches()
    for fn in (E._jitted_plan, E._jitted_autocorr, DP._jitted_analyze, DP._jitted_gather,
               DP._jitted_unpack_delta, DP._jitted_unpack_delta24, DP._jitted_unpack24,
               DP._jitted_padrows, PK._build, M._sharded_plan_fn):
        fn.cache_clear()


def encode_check(td, name, left, right, sr, depth, spy, timed=True):
    """CLI encode on the GPU vs the native host bytes, then a PCM-exact
    decode. Returns (first-encode seconds, warm-encode seconds)."""
    wav, ref, out, back = (td / f"{name}{s}" for s in (".wav", ".ref.lac", ".lac", ".back.wav"))
    write_input(wav, left, right, sr, depth)
    native_reference(wav, ref)
    rc, first = cli("encode", str(wav), str(out))
    plans = spy.take()
    if rc != 0 or not same_bytes(out, ref):
        raise AssertionError(f"{name}: GPU encode differs from the native host bytes")
    if plans == 0:
        raise AssertionError(f"{name}: the plane pipeline never planned on the GPU")
    warm = None
    if timed:
        rc, warm = cli("encode", str(wav), str(out))
        spy.take()
        if rc != 0 or not same_bytes(out, ref):
            raise AssertionError(f"{name}: warm GPU encode differs from the native host bytes")
    rc, _ = cli("decode", str(out), str(back))
    if rc != 0 or not same_bytes(back, wav):
        raise AssertionError(f"{name}: decode is not PCM-exact")
    frames = len(left)
    rate = f", warm {warm:.3f} s = {frames / warm:.0f} frames/s" if warm else ""
    log(f"  {name}: {frames} frames x2ch {sr} Hz/{depth}-bit, {plans} GPU plan dispatches, "
        f"bytes == native host, decode PCM-exact; first encode {first:.3f} s{rate}")
    for p in (out, back):
        p.unlink()
    return first, warm


def serve_check(td, spy):
    """Warm ``serve --workers=2``: pooled encodes must equal the native
    bytes, every pooled wave must have run, decodes must be PCM-exact."""
    from lac_tpu.serve import serve

    jobs = serve_inputs(td, SERVE_FILES)
    decodes = [(jobs[i][1], td / f"s{i}.back.wav", jobs[i][0]) for i in (0, 3)]
    lines = [f"encode {w} {o}" for w, o, _ in jobs] + ["wait"]
    lines += [f"decode {o} {b}" for o, b, _ in decodes] + ["wait", "quit"]
    out = io.StringIO()
    t0 = time.perf_counter()
    rc = serve(["--workers=2"], stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out)
    sec = time.perf_counter() - t0
    res = [json.loads(x) for x in out.getvalue().splitlines()]
    plans = spy.take()
    bad = [r for r in res if not r.get("ok")]
    if rc != 0 or bad or len(res) != len(lines) - 1:
        raise AssertionError(f"serve failed: rc={rc} {bad or res}")
    waits = [r for r in res if "drained" in r]
    if waits[0]["waves"] < 1 or any(w["failed_waves"] for w in waits):
        raise AssertionError(f"pooled waves did not all run: {waits}")
    for w, o, ref in jobs:
        if not same_bytes(o, ref):
            raise AssertionError(f"served {o} differs from the native host bytes")
    for o, b, wav in decodes:
        if not same_bytes(b, wav):
            raise AssertionError(f"served decode {b} is not PCM-exact")
    log(f"  serve --workers=2: {len(jobs)} encodes in {waits[0]['waves']} pooled waves "
        f"({plans} GPU plan dispatches, 0 failed), {len(decodes)} decodes; bytes == native "
        f"host, decodes PCM-exact; {sec:.3f} s")


def serve_inputs(td, count):
    jobs = []
    for i in range(count):
        sec = 9 + 7 * i  # 9..58 s: partial chunks that pool into shared waves
        depth, sr = (24, 48000) if i % 4 == 3 else (16, SR16)
        amp = (1 << (depth - 1)) - 1
        left, right = music(sec * sr, sr, int(amp * 0.7), seed=100 + i)
        wav, ref = td / f"s{i}.wav", td / f"s{i}.ref.lac"
        write_input(wav, left, right, sr, depth)
        native_reference(wav, ref)
        jobs.append((wav, td / f"s{i}.lac", ref))
    return jobs


# ----------------------------------------------------------- phase (d)


def numerics_checks():
    import jax
    import jax.numpy as jnp

    from lac_tpu import encoder as E
    from lac_tpu.ops import lpc, pallas_kernels as PK

    B = ROWS
    rng = np.random.RandomState(7)

    # autocorrelation: bf16 limb operands, dot_general with
    # preferred_element_type=f32 (TF32 does not apply to bf16 operands;
    # every partial sum is an integer < 2^24, so any split-K order is exact)
    for depth, nl in ((24, 5), (16, 4)):
        amp = 1 << (depth - 1)
        x = rng.randint(-amp, amp, (B, N)).astype(np.int32)
        x[0], x[1] = -amp, amp - 1  # full-scale boundary rows
        x[2, ::2], x[2, 1::2] = -amp, amp - 1
        got = np.asarray(E._jitted_autocorr(12, nl)(jnp.asarray(x)))
        if not np.array_equal(got, lpc.autocorrelation(x, 12)):
            raise AssertionError(f"autocorrelation_limbs({depth}-bit) differs from int64 lags")
        log(f"  autocorrelation_limbs {B}x{N} {depth}-bit ({nl} limbs, bf16 x bf16 -> f32): "
            "bit-equal to int64 lags")

    # plan_group on the GPU vs numpy, realistic blocks + extreme rows,
    # with the LPC candidates the product derives from exact lags
    left, right = music(B // 2 * N, SR16, 26000, seed=11)
    pcm = np.concatenate([left.reshape(-1, N), right.reshape(-1, N)])
    pcm[0] = rng.randint(-32768, 32768, N)
    pcm[1] = 0
    pcm[2, ::2], pcm[2, 1::2] = -32768, 32767
    coeffs, _used, valid, _mvo = E.lpc_candidates_from_lags(lpc.autocorrelation(pcm, 12), N)
    args = (jnp.asarray(pcm), jnp.asarray(coeffs), jnp.asarray(valid))
    meta_only = jax.device_get(E._jitted_plan(N, True, True, False)(*args))
    full = jax.device_get(E._jitted_plan(N, True, True, True)(*args))
    for lo in range(0, B, 32):  # per-lane program: the numpy reference in row chunks
        rows = slice(lo, lo + 32)
        ref = E.plan_group(pcm[rows], coeffs[:, rows], valid[:, rows], N, True, True, np)
        if not (np.array_equal(meta_only["meta"][rows], ref["meta"])
                and np.array_equal(full["meta"][rows], ref["meta"])
                and np.array_equal(full["ship"][rows], ref["ship"])):
            raise AssertionError(f"plan_group differs from numpy in rows {lo}..{lo + 31}")
    log(f"  plan_group {B}x{N} (meta-only and full-ship executables): meta and ship "
        "bit-equal to numpy")

    # the Triton scans vs XLA's cumsum at the width k_after_stateful uses
    if not PK.kernel_applicable(N):
        raise AssertionError("Triton scans not selected for the GPU at n=16384")
    u = jnp.asarray(rng.randint(0, 1 << 32, (B, 11, N), dtype=np.uint64).astype(np.uint32))
    u = u.at[0].set(np.uint32(0xFFFFFFFF))
    hi, lo = jax.jit(PK.split_cumsums_u32)(u)
    want_hi = jax.jit(lambda a: jnp.cumsum(a >> 16, axis=-1, dtype=jnp.uint32))(u)
    want_lo = jax.jit(lambda a: jnp.cumsum(a & 0xFFFF, axis=-1, dtype=jnp.uint32))(u)
    flags = (u & 0x10001).astype(jnp.uint32)
    got_c = jax.jit(PK.cumsum_u32)(flags)
    want_c = jax.jit(lambda a: jnp.cumsum(a, axis=-1, dtype=jnp.uint32))(flags)
    for name, g, w in (("split hi", hi, want_hi), ("split lo", lo, want_lo), ("cumsum", got_c, want_c)):
        if not bool(jnp.array_equal(g, w)):
            raise AssertionError(f"Triton {name} scan differs from XLA's cumsum")
    log(f"  Triton split_cumsums_u32 / cumsum_u32 ({B}x11x{N}): bit-equal to XLA cumsum")


# --------------------------------------------------------------- phases


def single_device(cache_state):
    import jax

    from lac_tpu import device_pipeline as DP

    spy = PlanSpy(1)
    td = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        import bench

        log("phase (a): CLI encode + decode vs native host bytes")
        left, right = bench.make_corpus()
        first, warm_corpus = encode_check(td, "corpus30s", left, right, SR16, 16, spy)
        if not DP.process_warm():
            raise AssertionError("device pipeline never marked the process warm")
        cold_first = first

        # (e) the same first encode again after dropping every in-memory
        # executable: executables now come from the persistent cache
        clear_in_memory_executables()
        wav, out = td / "corpus30s.wav", td / "corpus30s.lac"
        rc, cache_first = cli("encode", str(wav), str(out))
        spy.take()
        if rc != 0 or not same_bytes(out, td / "corpus30s.ref.lac"):
            raise AssertionError("corpus re-encode after cache reload differs")

        long_l, long_r = music(LONG_S * SR16, SR16, 27000, seed=21)
        _, warm_long = encode_check(td, "long10min", long_l, long_r, SR16, 16, spy)
        hr_l, hr_r = music(HIRES_S * SR24, SR24, 7_500_000, seed=31)
        hr_l[:4] = (-(1 << 23), (1 << 23) - 1, -(1 << 23), (1 << 23) - 1)  # boundary samples
        _, warm_hr = encode_check(td, "hires96k24", hr_l, hr_r, SR24, 24, spy)
        del long_l, long_r, hr_l, hr_r

        log("phase (b): CLI streaming route (>= LAC_TPU_STREAM_BLOCKS blocks)")
        st_l, st_r = music(STREAM_BLOCKS * N + 777, SR16, 24000, seed=41)
        encode_check(td, f"stream{STREAM_BLOCKS}blk", st_l, st_r, SR16, 16, spy, timed=False)
        del st_l, st_r
        for p in td.glob("*.wav"):
            p.unlink()

        log("phase (c): warm serve --workers=2")
        serve_check(td, spy)

        log("phase (d): numerics on the GPU at production width")
        numerics_checks()

        log("phase (e): timings (CLI wall incl. WAV read/write; record only, no claim)")
        cache_dir = jax.config.jax_compilation_cache_dir
        log(f"  first encode in this process (30 s corpus, compile cache at start: "
            f"{cache_state}): {cold_first:.3f} s")
        log(f"  first encode after dropping in-memory executables (compile cache warm, "
            f"{cache_dir}): {cache_first:.3f} s")
        for name, sec, frames in (("corpus30s", warm_corpus, 30 * SR16),
                                  ("long10min", warm_long, LONG_S * SR16),
                                  ("hires96k24", warm_hr, HIRES_S * SR24)):
            log(f"  warm encode {name}: {frames / sec:.0f} frames/s")
        peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
        log(f"  peak device memory: {peak} bytes")
    finally:
        shutil.rmtree(td, ignore_errors=True)


def multi_device(n):
    import jax

    from lac_tpu.parallel.mesh import default_mesh

    devs = jax.devices()
    if len(devs) != n:
        raise AssertionError(f"--devices {n} needs exactly {n} GPUs, found {len(devs)}")
    mesh = default_mesh()
    if mesh is None or mesh.devices.size != n:
        raise AssertionError("the default mesh does not span every GPU")
    spy = PlanSpy(n)
    td = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        log(f"sharded plane pipeline over a 1-D mesh of {n} GPUs")
        long_l, long_r = music(LONG_S * SR16, SR16, 27000, seed=21)
        encode_check(td, "long10min", long_l, long_r, SR16, 16, spy)
        del long_l, long_r
        log(f"pooled serve --workers=2 over the default {n}-GPU mesh")
        serve_check(td, spy)
    finally:
        shutil.rmtree(td, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="run only the multi-device checks, on exactly this many GPUs")
    args = ap.parse_args(argv)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()

    import lac_tpu

    lac_tpu.configure_jax()
    import jax

    from lac_tpu.runtime import native

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    if not native.native_available():
        raise SystemExit("the native runtime is unavailable: the plane pipeline cannot run")
    lib = pathlib.Path(native.get_native()._name).resolve()
    if lib.parent != native._BUILD.resolve() or not native._SRC.resolve().is_relative_to(ROOT):
        raise SystemExit(f"native runtime {lib} was not built from this checkout")
    cache_dir = jax.config.jax_compilation_cache_dir
    entries = len(list(pathlib.Path(cache_dir).glob("*"))) if cache_dir and os.path.isdir(cache_dir) else 0
    cache_state = "empty" if entries == 0 else f"{entries} entries"

    for line in card.splitlines():
        log(f"card: {line}")
    log(f"jax {jax.__version__}, devices {len(jax.devices())} x {jax.devices()[0].device_kind}")
    log(f"compile cache: {cache_dir} ({cache_state})")
    log(f"native runtime: {lib.name} built from {native._SRC.relative_to(ROOT)}")

    t0 = time.perf_counter()
    if args.devices:
        multi_device(args.devices)
    else:
        single_device(cache_state)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    for line in card.splitlines():
        log(f"card: {line}")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                             "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
