#!/usr/bin/env python3
"""Plan-executable measurements on the GPU: compile time, memory, run
time, and the Triton scan kernels against XLA's own scans.

    python scripts/kernel_bench.py [--out DIR] [--skip-e2e]

Prints, beside the card name and power limit:

* compile time and ``memory_analysis`` of the (128, 16384) and
  (256, 16384) plan executables and of the analyze executables;
* plan-executable run time at B = 128 and 256 with the Triton scans
  (the product choice on the GPU) and with XLA's ``cumsum``;
* standalone scan times and their share of the HBM roofline, the fused
  k-cost reduction's time and its fusion count in the optimized HLO;
* top device operations of one traced (256, 16384) plan execution;
* the warm in-memory encode of a 10-minute 44.1 kHz/16-bit stereo file
  (bench.make_long content)
  with each scan variant, run in turns (Triton, XLA, XLA, Triton), and
  the peak device memory of that encode.

Writes the optimized HLO, the trace and a JSON summary under ``--out``
(default ``.cache/kernel_bench`` in the checkout). Needs a GPU; exits nonzero
without one.
"""

import argparse
import functools
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

N = 16384
BATCHES = (128, 256)  # plan batch widths of the chunk ladder's top rungs
E2E_SECONDS = 600
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def log(msg):
    print(msg, flush=True)


def timed(fn, *args, reps=20):
    """(median, min) seconds of fn(*args) to completion, after 3 warmups."""
    import jax

    for _ in range(3):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(min(ts))


def use_scans(kind):
    """Point adapt.k_after_stateful at the Triton scans or XLA's cumsum
    and drop every cached plan executable."""
    import jax

    from lac_tpu import encoder as E
    from lac_tpu.ops import pallas_kernels as PK

    PK.kernel_applicable = (lambda n: n % PK._TILE == 0) if kind == "triton" else (lambda n: False)
    E._jitted_plan.cache_clear()
    jax.clear_caches()


def plan_inputs(B):
    from bench import make_long
    from lac_tpu import encoder as E
    from lac_tpu.ops import lpc

    left, right = make_long(5, frames=B // 2 * N)
    pcm = np.concatenate([left.reshape(-1, N), right.reshape(-1, N)])
    coeffs, _u, valid, _m = E.lpc_candidates_from_lags(lpc.autocorrelation(pcm, 12), N)
    return pcm, coeffs, valid


def plan_section(out, summary):
    import jax
    import jax.numpy as jnp

    from lac_tpu.encoder import plan_group

    for B in BATCHES:
        pcm, coeffs, valid = plan_inputs(B)
        args = [jax.device_put(a) for a in (pcm, coeffs, valid)]
        for kind in ("triton", "xla"):
            use_scans(kind)
            fn = jax.jit(functools.partial(plan_group, n=N, zero_run_enabled=True,
                                           partitioning_enabled=True, xp=jnp, emit_fields=False))
            try:
                t0 = time.perf_counter()
                compiled = fn.lower(*args).compile()
                comp = time.perf_counter() - t0
                mem = compiled.memory_analysis()
                med, best = timed(compiled, *args)
            except Exception as e:  # noqa: BLE001 — report and measure the rest
                log(f"plan ({B}, {N}) scans={kind}: FAILED {e!r}"[:3000])
                continue
            rec = {"compile_s": comp, "median_s": med, "min_s": best,
                   "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
                   "arg_bytes": getattr(mem, "argument_size_in_bytes", None),
                   "out_bytes": getattr(mem, "output_size_in_bytes", None)}
            summary[f"plan_{B}_{kind}"] = rec
            log(f"plan ({B}, {N}) scans={kind}: compile {comp:.1f} s, run median {med * 1e3:.3f} ms "
                f"(min {best * 1e3:.3f}), temp {rec['temp_bytes']} B")
            if B == BATCHES[-1] and kind == "xla":
                (out / "plan256_xla.hlo.txt").write_text(compiled.as_text())
                trace_plan(out, compiled, args, summary)
    use_scans("triton")


def trace_plan(out, compiled, args, summary):
    """Trace three executions and list the device ops by total time."""
    import jax

    tdir = out / "trace_plan256_xla"
    with jax.profiler.trace(str(tdir)):
        for _ in range(3):
            jax.block_until_ready(compiled(*args))
    files = sorted(tdir.glob("**/*.xplane.pb"))
    if not files:
        log("trace: no xplane file written")
        return
    pd = jax.profiler.ProfileData.from_file(str(files[-1]))
    tot = {}
    for plane in pd.planes:
        if "gpu" not in plane.name.lower():
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
    busy = sum(tot.values())
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:20]
    summary["plan256_xla_trace_top"] = [(k, v / 3e6) for k, v in top]
    log(f"trace plan (256, {N}) XLA scans: device op time {busy / 3e6:.3f} ms per run; top ops:")
    for name, ns in top:
        log(f"  {ns / 3e6:8.3f} ms  {ns / busy:6.1%}  {name[:100]}")


def scan_section(summary):
    import jax
    import jax.numpy as jnp

    from lac_tpu.encoder import _k_costs_stack
    from lac_tpu.ops import pallas_kernels as PK

    rng = np.random.RandomState(3)
    for B in BATCHES:
        rows = B * 11  # every candidate lane of a plan batch
        u = jax.device_put(rng.randint(0, 1 << 32, (rows, N), dtype=np.uint64).astype(np.uint32))
        nbytes = rows * N * 4
        xla_split = jax.jit(lambda a: (jnp.cumsum(a >> 16, axis=-1, dtype=jnp.uint32),
                                       jnp.cumsum(a & 0xFFFF, axis=-1, dtype=jnp.uint32)))
        cases = {
            "split_cumsum_xla": (xla_split, 3 * nbytes),
            "split_cumsum_triton": (jax.jit(PK.split_cumsums_u32), 3 * nbytes),
            "cumsum_xla": (jax.jit(lambda a: jnp.cumsum(a, axis=-1, dtype=jnp.uint32)), 2 * nbytes),
            "cumsum_triton": (jax.jit(PK.cumsum_u32), 2 * nbytes),
            "cummax_xla": (jax.jit(lambda a: jax.lax.cummax(a.astype(jnp.int32), axis=1)), 2 * nbytes),
            "cummin_rev_xla": (jax.jit(lambda a: jax.lax.cummin(a.astype(jnp.int32), axis=1,
                                                                 reverse=True)), 2 * nbytes),
        }
        for name, (fn, moved) in cases.items():
            try:
                med, best = timed(fn, u)
            except Exception as e:  # noqa: BLE001 — report and measure the rest
                log(f"{name}: FAILED {e!r}"[:3000])
                continue
            share = moved / HBM_BYTES_PER_S / med
            summary[f"{name}_{rows}"] = {"median_s": med, "min_s": best, "hbm_share": share}
            log(f"{name} ({rows}, {N}): median {med * 1e3:.3f} ms, min {best * 1e3:.3f} ms, "
                f"{moved / med / 1e9:.0f} GB/s = {share:.1%} of HBM peak")

        u3 = u.reshape(B, 11, N)
        kc = jax.jit(lambda a: _k_costs_stack(a, 16, jnp))
        compiled = kc.lower(u3).compile()
        hlo = compiled.as_text()
        fusions = [ln for ln in hlo.splitlines() if " fusion(" in ln and "ENTRY" not in ln]
        med, best = timed(compiled, u3)
        share = nbytes / HBM_BYTES_PER_S / med
        summary[f"k_costs_{B}"] = {"median_s": med, "fusion_calls": len(fusions), "hbm_share": share}
        log(f"k-cost sums ({B}, 11, {N}) XLA: median {med * 1e3:.3f} ms = {share:.1%} of HBM peak "
            f"for one read; {len(fusions)} fusion calls in the optimized HLO:")
        for ln in fusions[:25]:
            log(f"  {ln.strip()[:160]}")


def analyze_section(summary):
    import jax

    from lac_tpu import device_pipeline as DP

    for K, dt in ((64, "int16"), (128, "int16"), (256, "int16"), (256, "int32")):
        z = jax.device_put(np.zeros((K, N), dt))
        t0 = time.perf_counter()
        compiled = DP._jitted_analyze(K, "auto", dt, None).lower(z, z).compile()
        comp = time.perf_counter() - t0
        mem = compiled.memory_analysis()
        summary[f"analyze_{K}_{dt}"] = {"compile_s": comp,
                                        "temp_bytes": getattr(mem, "temp_size_in_bytes", None)}
        log(f"analyze K={K} {dt} (auto): compile {comp:.1f} s, temp "
            f"{getattr(mem, 'temp_size_in_bytes', None)} B")


def e2e_section(summary):
    import jax
    import jax.numpy as jnp

    from bench import make_long
    from lac_tpu.encoder import FrameEncoder

    left, right = make_long(21, frames=E2E_SECONDS * 44100)
    dev = jax.devices()[0]
    results = {"triton": [], "xla": []}
    for kind in ("triton", "xla"):  # compile both variants once
        use_scans(kind)
        try:
            FrameEncoder(12, 2, 44100, 16, xp=jnp).encode(left, right)
        except Exception as e:  # noqa: BLE001 — report and measure the rest
            log(f"10-min encode scans={kind}: FAILED {e!r}"[:3000])
            results.pop(kind)
    for kind in ("triton", "xla", "xla", "triton", "triton", "xla"):
        if kind not in results:
            continue
        use_scans(kind)
        enc = FrameEncoder(12, 2, 44100, 16, xp=jnp)
        enc.encode(left, right)  # reload this variant's executables
        t0 = time.perf_counter()
        enc.encode(left, right)
        results[kind].append(time.perf_counter() - t0)
        log(f"10-min warm encode scans={kind}: {results[kind][-1]:.3f} s = "
            f"{len(left) / results[kind][-1]:.0f} frames/s")
    stats = dev.memory_stats() or {}
    summary["e2e_10min"] = results
    summary["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    summary["bytes_limit"] = stats.get("bytes_limit")
    log(f"10-min encode peak device memory {stats.get('peak_bytes_in_use')} B of "
        f"{stats.get('bytes_limit')} B (LAC_TPU_PIPE_DEPTH={os.environ.get('LAC_TPU_PIPE_DEPTH', '2')}, K=256)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / ".cache" / "kernel_bench"))
    ap.add_argument("--skip-e2e", action="store_true")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    import lac_tpu

    lac_tpu.configure_jax()
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    log(f"card: {card}; jax {jax.__version__}")
    summary = {"card": card}
    try:
        analyze_section(summary)
        plan_section(out, summary)
        scan_section(summary)
        if not args.skip_e2e:
            e2e_section(summary)
    finally:
        (out / "summary.json").write_text(json.dumps(summary, indent=1))
    log(f"card: {card}")


if __name__ == "__main__":
    main()
