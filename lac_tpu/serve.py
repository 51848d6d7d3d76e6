"""Persistent warm-process codec service.

The reference is a one-shot CLI (main.cpp:600-918): every invocation
pays full process startup. On a device backend that cost is dominated by
backend start-up and compiling or loading the XLA executables — fine
for one long file, hopeless for many short ones. This module keeps ONE
process alive and routes any number of jobs
through it: every jitted executable, the native runtime, and the device
plane pipeline stay warm in the module-level caches, so the Nth file
encodes at full device throughput with zero per-file setup.

Usage:

    python -m lac_tpu.serve [--workers=N] [--warm[=BLOCKS]] [--no-pool]

With ``--workers>1``, queued encode jobs are pooled: their full
16384-sample blocks fill shared K-wide device chunks (lac_tpu.pool), so
many short files sustain the long-file chunk rate instead of each file
ending on a padded partial chunk. ``--no-pool`` (or
``LAC_TPU_SERVE_POOL=0``) restores one pipeline per file.

Protocol (line-oriented, stdin -> stdout, one JSON object per line):

    encode <in.wav> <out.lac> [encode flags...]   # same flags as the CLI
    decode <in.lac> <out.wav> [decode flags...]
    warm [BLOCKS]        # synthetic encode to pull executables in now
    wait                 # barrier: responds after all prior jobs finish
    ping                 # liveness probe
    quit                 # drain in-flight jobs, then exit 0 (EOF too)

With ``--workers>1`` jobs run concurrently and finish in any order, so
a piped script whose later jobs read earlier jobs' outputs (encode then
decode the same file) must put ``wait`` between the phases.

Responses (completion order when --workers>1; ``id`` is the 1-based
request line number):

    {"id": 1, "ok": true, "rc": 0, "message": "Encoded a.wav -> a.lac (123 bytes)", "ms": 41.7}
    {"id": 2, "ok": false, "rc": 1, "error": "Failed to read WAV: missing.wav", "ms": 0.3}

Paths with spaces use shell quoting (lines are shlex-split). Job
execution reuses the CLI entry points verbatim, so staged atomic
output, flag parsing, env resolution, and message shapes are identical
to ``lac_cli`` — a failed job never clobbers an existing output file.
"""

import io
import json
import os
import shlex
import signal
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

__all__ = ["serve", "run_job", "warm_process"]


class _ThreadRouter(io.TextIOBase):
    """A stdout/stderr proxy that routes writes to a per-thread buffer
    when one is registered, else to the real stream. Lets concurrent
    jobs capture their CLI messages without interleaving."""

    def __init__(self, fallback):
        super().__init__()
        self.fallback = fallback
        self.local = threading.local()

    def write(self, s):
        buf = getattr(self.local, "buf", None)
        (self.fallback if buf is None else buf).write(s)
        return len(s)

    def flush(self):
        if getattr(self.local, "buf", None) is None:
            self.fallback.flush()

    def writable(self):
        return True


def run_job(argv):
    """Run one CLI job vector (e.g. ["encode", "a.wav", "a.lac"]) in
    this process; returns (rc, stdout_text, stderr_text)."""
    from . import cli

    out_router = sys.stdout if isinstance(sys.stdout, _ThreadRouter) else None
    err_router = sys.stderr if isinstance(sys.stderr, _ThreadRouter) else None
    out_buf, err_buf = io.StringIO(), io.StringIO()
    if out_router is not None:
        out_router.local.buf = out_buf
    if err_router is not None:
        err_router.local.buf = err_buf
    try:
        if out_router is None:  # direct library use, no serve loop active
            from contextlib import redirect_stderr, redirect_stdout

            with redirect_stdout(out_buf), redirect_stderr(err_buf):
                rc = cli.main(argv)
        else:
            rc = cli.main(argv)
    finally:
        if out_router is not None:
            out_router.local.buf = None
        if err_router is not None:
            err_router.local.buf = None
    return rc, out_buf.getvalue(), err_buf.getvalue()


def warm_process(blocks=128, dtypes=("int16", "int32")):
    """Pull the hot executables into this process now by encoding a
    synthetic stereo signal of ``blocks`` full blocks in memory (device
    backends load their cached executables here instead of on the first
    real job). Cold-start routing (LAC_TPU_COLD_BLOCKS) is suspended
    for the warm encode — sending short inputs to the native planner is
    exactly what warming exists to stop. No-op-cheap on numpy.

    ``dtypes`` restricts the upload-shape grid by plane dtype: a caller
    that will only see 16-bit jobs can skip the int32 pad / pack24 /
    delta24 executables, each one less to compile or load before the
    first real job."""
    import numpy as np

    from .cli import _encoder_xp
    from .encoder import FrameEncoder
    from .format import constants as C

    dbg = os.environ.get("LAC_TPU_WARM_DEBUG") == "1"
    t_last = [time.perf_counter()]

    def _stage(name):
        if dbg:
            now = time.perf_counter()
            sys.stderr.write(f"warm[{name}] {now - t_last[0]:.1f}s\n")
            sys.stderr.flush()
            t_last[0] = now

    # full blocks take the plane pipeline; the partial tail block walks
    # the legacy group path (probe + bucket executables, padded to the
    # power-of-two length bucket) — real files almost always have a
    # tail, so load those here too, not on job 1. A tail just under a
    # full block hits the 16384 bucket, the one any tail >8192 uses.
    n = int(blocks) * C.MAX_BLOCK_SIZE + C.MAX_BLOCK_SIZE - 7
    rng = np.random.RandomState(7)
    left = rng.randint(-(1 << 14), 1 << 14, n).astype(np.int32)
    right = (left // 2 + rng.randint(-(1 << 8), 1 << 8, n)).astype(np.int32)
    enc = FrameEncoder(12, C.STEREO_PER_BLOCK, 44100, 16, xp=_encoder_xp())
    from .ops._backend import is_jax as _is_jax

    if _is_jax(enc.xp):
        # warm the SAME route real jobs take: the product-default mesh
        from .parallel.mesh import default_mesh

        mesh = default_mesh()
        if mesh is not None:
            enc.set_mesh(mesh)
    # instance flag, NOT env mutation: concurrent warm jobs would race
    # an LAC_TPU_COLD_BLOCKS save/restore and perturb other jobs' routing
    enc.suppress_cold_route = True

    from .ops._backend import is_jax

    if is_jax(enc.xp):
        # exec-grid FIRST (thread-pooled), synthetic encode AFTER: the
        # grid covers most executables the encode route walks (plans,
        # probe chains, pads, delta unpacks), so front-loading it
        # overlaps those compiles/loads and the serial encode only pays
        # for the uncovered remainder.
        # Among them: a chunk whose plan lanes exceed K (stereo-
        # uncertain blocks plan two speculative variants each) takes the
        # DOUBLED plan dispatch (device_pipeline.plan_batches) — load
        # every ladder plan width now, not on the first uncertain file
        import jax

        from . import device_pipeline as DP
        from . import encoder as E
        from .format import constants as C
        from .runtime.native import native_available

        emit_fields = not native_available()
        widths = (DP.CHUNK_BLOCKS,) if DP.CHUNK_BLOCKS else DP.CHUNK_LADDER
        mesh = enc.mesh
        nd = 1 if mesh is None else int(np.prod(list(mesh.shape.values())))
        widths = tuple(w for w in widths if w % nd == 0)

        def _put_sharded(a):
            # lane axis is axis 1 for the (5, bp, 13)/(5, bp) LPC inputs
            from jax.sharding import NamedSharding, PartitionSpec as SP

            from .parallel.mesh import BLOCK_AXIS

            spec = SP(None, BLOCK_AXIS) if a.ndim == 2 else SP(None, BLOCK_AXIS, None)
            return jax.device_put(a, NamedSharding(mesh, spec))

        def _load_plan(bp):
            if mesh is not None:
                from .parallel.mesh import _sharded_plan_fn

                fn = _sharded_plan_fn(mesh, C.MAX_BLOCK_SIZE, enc.zero_run_enabled,
                                      enc.partitioning_enabled, False)
                from jax.sharding import NamedSharding, PartitionSpec as SP

                from .parallel.mesh import BLOCK_AXIS

                jax.block_until_ready(fn(
                    jax.device_put(np.zeros((bp, C.MAX_BLOCK_SIZE), np.int32),
                                   NamedSharding(mesh, SP(BLOCK_AXIS, None))),
                    _put_sharded(np.zeros((5, bp, 13), np.int16)),
                    _put_sharded(np.zeros((5, bp), bool)),
                )["meta"])
                return
            fn = E._jitted_plan(C.MAX_BLOCK_SIZE, enc.zero_run_enabled,
                                enc.partitioning_enabled, emit_fields)
            jax.block_until_ready(fn(
                jax.device_put(np.zeros((bp, C.MAX_BLOCK_SIZE), np.int32)),
                jax.device_put(np.zeros((5, bp, 13), np.int16)),
                jax.device_put(np.zeros((5, bp), bool)),
            )["meta"])

        # partial-chunk upload-bucket pads (tiny concat executables; a
        # file whose full-block count is not a multiple of K hits one).
        # The step MUST come from the same env-derived grid the pipeline
        # uses (LAC_TPU_UPLOAD_BUCKET_DIV) or the warmed shapes miss.
        def _load_pad(b, K, dt):
            jax.block_until_ready(DP._jitted_padrows(b, K, str(np.dtype(dt)))(
                jax.device_put(np.zeros((b, DP.N), dt))))

        def _load_unpack24(b, K):
            jax.block_until_ready(DP._jitted_unpack24(b, K)(
                jax.device_put(np.zeros((3, b, DP.N), np.uint8))))

        # stereo-probe executables: the synthetic encode's strongly-
        # correlated content decides every block certainly, so the
        # uncertain-block probe gather + probe plan never load from it —
        # a real file's first uncertain block would pay them here
        def _load_probe_chain(K):
            if mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as SP

                from .parallel.mesh import BLOCK_AXIS, _sharded_plan_fn

                sh = NamedSharding(mesh, SP(BLOCK_AXIS, None))
                z = jax.device_put(np.zeros((K, DP.N), np.int16), sh)
                out = DP._jitted_analyze(K, "auto", "int16", mesh)(z, z)
                fnp = _sharded_plan_fn(mesh, C.STEREO_PROBE_SIZE,
                                       enc.zero_run_enabled,
                                       enc.partitioning_enabled, False)
                jax.block_until_ready(fnp(
                    out["probes"],
                    _put_sharded(np.zeros((5, 12 * K, 13), np.int16)),
                    _put_sharded(np.zeros((5, 12 * K), bool)),
                )["meta"])
                return
            out = DP._jitted_analyze(K, "auto", "int16", None)(
                jax.device_put(np.zeros((K, DP.N), np.int16)),
                jax.device_put(np.zeros((K, DP.N), np.int16)),
            )
            probe_rows = jax.device_put(np.zeros(12 * K, np.int32))
            jax.block_until_ready(DP._jitted_gather(DP.PROBE)(out["probes"], probe_rows))
            fnp = E._jitted_plan(C.STEREO_PROBE_SIZE, enc.zero_run_enabled,
                                 enc.partitioning_enabled, emit_fields)
            jax.block_until_ready(fnp(
                jax.device_put(np.zeros((12 * K, C.STEREO_PROBE_SIZE), np.int32)),
                jax.device_put(np.zeros((5, 12 * K, 13), np.int16)),
                jax.device_put(np.zeros((5, 12 * K), bool)),
            )["meta"])

        # the last serial lazy loads a real encode pays after this grid
        # (enumerated from a JAX_LOG_COMPILES warm capture): the
        # plan-lane gather over the chunk-resident (4K, N) planes and
        # the tail group's probe autocorr + plan (12 probe lanes padded
        # to Bp=16). OPT-IN ONLY (LAC_TPU_WARM_EXTRA=1): not yet
        # measured on the GPU (ROADMAP.md).
        def _load_lane_gather(K, bp):
            import jax.numpy as jnp

            flat = jnp.zeros((4 * K, DP.N), jnp.int32)
            rows = jax.device_put(np.zeros(bp, np.int32))
            jax.block_until_ready(DP._jitted_gather(DP.N)(flat, rows))

        def _load_group_probe():
            from .encoder import _jitted_autocorr

            pcm = jax.device_put(np.zeros((16, C.STEREO_PROBE_SIZE), np.int16))
            jax.block_until_ready(_jitted_autocorr(12, 4)(pcm))
            fnp = E._jitted_plan(C.STEREO_PROBE_SIZE, enc.zero_run_enabled,
                                 enc.partitioning_enabled, emit_fields)
            jax.block_until_ready(fnp(
                pcm,
                jax.device_put(np.zeros((5, 16, 13), np.int16)),
                jax.device_put(np.zeros((5, 16), bool)),
            )["meta"])

        def _load_unpack_delta(db, bk, K):
            W = 2 + {8: DP.N, 12: DP.N * 3 // 2, 14: DP.N * 7 // 4}[db]
            jax.block_until_ready(DP._jitted_unpack_delta(db, bk, K)(
                jax.device_put(np.zeros((bk, W), np.uint8))))

        def _load_unpack_delta24(db, bk, K):
            W = 3 + DP.N * db // 8
            jax.block_until_ready(DP._jitted_unpack_delta24(db, bk, K)(
                jax.device_put(np.zeros((bk, W), np.uint8))))

        thunks = [(lambda bp=bp: _load_plan(bp)) for bp in widths]
        thunks += [(lambda K=K: _load_probe_chain(K)) for K in widths]
        if mesh is None and os.environ.get("LAC_TPU_WARM_EXTRA") == "1":
            for K in widths:
                for bp in ({K, 2 * K} if 2 * K in DP.CHUNK_LADDER else {K}):
                    thunks.append(lambda K=K, bp=bp: _load_lane_gather(K, bp))
            thunks.append(_load_group_probe)
        if mesh is None:  # mesh chunks keep full-K host pads, no pack24/delta
            for K in widths:
                step = DP._bucket_step(K)
                for b in range(step, K, step):
                    for dt in (np.int16, np.int32):
                        if np.dtype(dt).name in dtypes:
                            thunks.append(lambda b=b, K=K, dt=dt: _load_pad(b, K, dt))
                if "int32" in dtypes and DP._pack24_enabled("int32", None):
                    for b in (*range(step, K, step), K):
                        thunks.append(lambda b=b, K=K: _load_unpack24(b, K))
                if "int16" in dtypes and DP._delta_enabled("int16", None):
                    # the common audio tiers (12/14) warm every bucket;
                    # the quiet tier (8) warms the full-chunk shape only
                    # (rarer content; a miss is one lazy load)
                    for db in (12, 14):
                        for bk in (*range(step, K, step), K):
                            thunks.append(
                                lambda db=db, bk=bk, K=K: _load_unpack_delta(db, bk, K))
                    thunks.append(lambda K=K: _load_unpack_delta(8, K, K))
                if "int32" in dtypes and DP._delta24_enabled("int32", None):
                    # loud 24-bit music lands in the 20-bit tier
                    # (deltas scale with peak x spectral centroid;
                    # measured on 22-bit-peak music-shape content),
                    # quieter/duller content in the 16-bit tier — warm
                    # both at every bucket; 12 full-chunk only (a miss
                    # is one lazy load)
                    for db in (16, 20):
                        for bk in (*range(step, K, step), K):
                            thunks.append(
                                lambda db=db, bk=bk, K=K: _load_unpack_delta24(db, bk, K))
                    thunks.append(lambda K=K: _load_unpack_delta24(12, K, K))

        # each thunk is one independent executable compile or load;
        # overlap them (LAC_TPU_WARM_THREADS=1 restores strictly serial
        # loads)
        try:
            warm_threads = max(1, int(os.environ.get("LAC_TPU_WARM_THREADS", "4")))
        except ValueError:
            warm_threads = 4
        if warm_threads == 1:
            for t in thunks:
                t()
        else:
            with ThreadPoolExecutor(max_workers=warm_threads) as tp:
                for f in [tp.submit(t) for t in thunks]:
                    f.result()  # propagate the first load failure
        _stage(f"exec-grid x{warm_threads}")
    nbytes = len(enc.encode(left, right))
    _stage("encode")
    return nbytes


def _respond(lock, out, obj):
    line = json.dumps(obj, separators=(", ", ": "))
    with lock:
        out.write(line + "\n")
        out.flush()


class _PoolBatcher:
    """Cross-file chunk batching for encode jobs (lac_tpu.pool).

    The reference's thread pool fills every core with one-block tasks
    regardless of provenance (lac/encoder.cpp:259-443); this is the
    device-path equivalent: encode jobs queued while a wave is running
    accumulate, then the batcher drains them all at once, pools the
    compatible ones' full blocks into shared K-wide device chunks, and
    releases each file to a worker-pool finish task (tail block, frame
    assembly, staged write — the ordinary CLI path with the WAV and the
    plane results injected) as soon as its chunks have emitted. Pooled
    waves shard over the product-default device mesh just like one-shot
    CLI encodes. Jobs that can't pool (debug flags, streaming route,
    numpy backend, bad args) fall back to the ordinary per-job handler,
    which reproduces every message and exit code exactly.

    A wave that raises is logged with its traceback and counted
    (``failed_waves``, reported by ``wait``); its unreleased files then
    take the ordinary per-job path, so every job is still answered.
    """

    def __init__(self, pool, handle, respond):
        self.pool = pool  # worker ThreadPoolExecutor (fallbacks + finishes)
        self.handle = handle  # ordinary job handler(job_id, parts)
        self.respond = respond  # respond(obj)
        self.cv = threading.Condition()
        self.pending = []
        self.closed = False
        self.busy = 0  # accepted jobs not yet responded
        self.fenced = 0  # accepted since the last drain (wait counting)
        self.waves = 0  # pooled device waves started
        self.failed_waves = 0  # waves that raised (jobs fell back per job)
        self.thread = threading.Thread(target=self._loop, daemon=True)
        self.thread.start()

    def submit(self, job_id, parts):
        with self.cv:
            self.busy += 1
            self.fenced += 1
            self.pending.append((job_id, parts, time.perf_counter()))
            self.cv.notify_all()

    def drain(self):
        """Block until every accepted job has been responded to; returns
        the number of jobs fenced since the previous drain (the `wait`
        response counts them alongside the direct worker futures)."""
        with self.cv:
            while self.busy:
                self.cv.wait()
            n, self.fenced = self.fenced, 0
            return n

    def close(self):
        with self.cv:
            self.closed = True
            self.cv.notify_all()
        self.thread.join()

    def _done_one(self):
        with self.cv:
            self.busy -= 1
            self.cv.notify_all()

    def _loop(self):
        from . import pool as P

        while True:
            with self.cv:
                while not self.pending and not self.closed:
                    self.cv.wait()
                if not self.pending and self.closed:
                    return
                batch, self.pending = self.pending, []
            routed = set()  # batch indices _process dispatched or requeued
            try:
                self._process(batch, P, routed)
            except Exception:  # noqa: BLE001 — keep the batcher alive
                traceback.print_exc()
                # _process records every entry it dispatched (to
                # _finish/_fallback) or requeued in `routed` — falling
                # those back again would run them twice and drive `busy`
                # negative. Only the unrouted remainder falls back.
                for bi, (job_id, parts, _t0) in enumerate(batch):
                    if bi not in routed:
                        self.pool.submit(self._fallback, job_id, parts)

    def _fallback(self, job_id, parts):
        try:
            self.handle(job_id, parts)
        finally:
            self._done_one()

    def _finish(self, job_id, parts, prep, planes, t0):
        from . import cli

        try:
            try:
                cli._set_encode_injection(prep.in_path, prep.wav, planes)
                try:
                    rc, out_text, err_text = run_job(parts)
                finally:
                    cli._pop_encode_injection(prep.in_path)  # defensive clear
                res = {"id": job_id, "ok": rc == 0, "rc": rc}
                if out_text.strip():
                    res["message"] = out_text.strip()
                if err_text.strip():
                    res["error"] = err_text.strip()
            except Exception as e:  # noqa: BLE001 — service boundary
                res = {"id": job_id, "ok": False, "rc": 1, "error": str(e)}
            res["ms"] = round((time.perf_counter() - t0) * 1e3, 1)
            self.respond(res)
        finally:
            # ack only AFTER the response is on the wire: drain()/wait
            # promises every accepted job has been responded to (the
            # non-pooled path responds inside handle() before its
            # future resolves)
            self._done_one()

    def _process(self, batch, P, routed):
        groups = {}
        pooled_blocks = 0
        for bi, (job_id, parts, t0) in enumerate(batch):
            if pooled_blocks >= P._MAX_WAVE_BLOCKS:
                # prescreening reads each WAV whole; cap what is resident
                # at once to ~one wave's worth and requeue the remainder
                # at the FRONT (order-preserving — submit already counted
                # their busy/fenced) for the next loop pass
                with self.cv:
                    self.pending[:0] = batch[bi:]
                routed.update(range(bi, len(batch)))
                break
            prep = None
            try:
                prep = P.prepare_encode_job(parts)
            except Exception:  # noqa: BLE001 — prescreen must never kill a job
                prep = None
            if prep is None:
                routed.add(bi)
                self.pool.submit(self._fallback, job_id, parts)
            else:
                groups.setdefault(prep.key, []).append((bi, job_id, parts, t0, prep))
                pooled_blocks += prep.nfull
        for jobs in groups.values():
            for wave in P.split_waves(jobs, nfull_of=lambda rec: rec[4].nfull):
                released = set()

                def done(i, planes, wave=wave, released=released, routed=routed):
                    bi, job_id, parts, t0, prep = wave[i]
                    # submit BEFORE marking released/routed: a failed
                    # submit (executor shutting down) must leave the job
                    # eligible for the unreleased-fallback path below, or
                    # it would never be responded to
                    self.pool.submit(self._finish, job_id, parts, prep, planes, t0)
                    released.add(i)
                    routed.add(bi)

                self.waves += 1
                try:
                    P.run_group_wave([rec[4] for rec in wave], done)
                except Exception:  # noqa: BLE001 — wave failed mid-flight
                    self.failed_waves += 1
                    traceback.print_exc()
                    # unreleased files take the ordinary per-job path
                    # (fresh read + per-file pipeline; same bytes)
                    for i, (bi, job_id, parts, _t0, _p) in enumerate(wave):
                        if i not in released:
                            self.pool.submit(self._fallback, job_id, parts)
                            routed.add(bi)


def serve(argv=None, stdin=None, stdout=None):
    """Run the service loop; returns the process exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    workers = 1
    warm_blocks = None
    pooling = os.environ.get("LAC_TPU_SERVE_POOL", "1") != "0"
    for flag in argv:
        if flag.startswith("--workers="):
            try:
                workers = max(1, int(flag.split("=", 1)[1]))
            except ValueError:
                sys.stderr.write(f"Bad flag value: {flag}\n")
                return 1
        elif flag == "--warm":
            warm_blocks = 128
        elif flag.startswith("--warm="):
            try:
                warm_blocks = max(1, int(flag.split("=", 1)[1]))
            except ValueError:
                sys.stderr.write(f"Bad flag value: {flag}\n")
                return 1
        elif flag == "--no-pool":
            pooling = False
        elif flag == "--pool":
            pooling = True
        else:
            sys.stderr.write(
                "Usage: python -m lac_tpu.serve [--workers=N] [--warm[=BLOCKS]] [--no-pool]\n"
            )
            return 1

    stdin = sys.stdin if stdin is None else stdin
    lock = threading.Lock()

    # Protocol isolation: clients parse one JSON object per line off our
    # stdout, but _ThreadRouter only intercepts Python-level writes — a
    # native library or XLA/absl printing to FILE DESCRIPTOR 1 directly
    # would interleave into the response stream. Dup the real stdout for
    # protocol responses and point fd 1 at stderr for the loop lifetime,
    # so raw-fd writers can never corrupt a response line.
    fd_saved = None
    if stdout is None:
        real_out = None
        try:
            fd_saved = os.dup(1)
            real_out = os.fdopen(fd_saved, "w")
            sys.stdout.flush()
            os.dup2(sys.stderr.fileno(), 1)
        except (OSError, ValueError, io.UnsupportedOperation):
            # don't leak the dup'd descriptor when a later step fails
            # (e.g. sys.stderr has no real fileno): close whichever
            # handle owns it before falling back (advisor round-4)
            if real_out is not None:
                real_out.close()  # owns and closes fd_saved
            elif fd_saved is not None:
                os.close(fd_saved)
            fd_saved = None
            real_out = sys.stdout
    else:
        real_out = stdout

    # route job-thread CLI prints into per-job buffers for the lifetime
    # of the loop; protocol responses go to the real stream
    prev_out, prev_err = sys.stdout, sys.stderr
    sys.stdout = _ThreadRouter(prev_out)
    sys.stderr = _ThreadRouter(prev_err)

    if warm_blocks is not None:
        t0 = time.perf_counter()
        warm_process(warm_blocks)
        _respond(lock, real_out, {
            "id": 0, "ok": True, "warmed_blocks": warm_blocks,
            "ms": round((time.perf_counter() - t0) * 1e3, 1),
        })

    pool = ThreadPoolExecutor(max_workers=workers)
    outstanding = []

    def _handle_fwd(job_id, parts):
        return handle(job_id, parts)

    # cross-file chunk batching: only with --workers>1 — a single-worker
    # service keeps strict job FIFO (piped encode-then-decode scripts
    # rely on it), which batching inherently reorders
    batcher = (
        _PoolBatcher(pool, _handle_fwd, lambda obj: _respond(lock, real_out, obj))
        if pooling and workers > 1
        else None
    )

    def handle(job_id, parts):
        t0 = time.perf_counter()
        try:
            if parts[0] == "warm":
                blocks = int(parts[1]) if len(parts) > 1 else 128
                nbytes = warm_process(blocks)
                res = {"id": job_id, "ok": True, "warmed_blocks": blocks,
                       "bytes": nbytes}
            else:
                rc, out_text, err_text = run_job(parts)
                res = {"id": job_id, "ok": rc == 0, "rc": rc}
                if out_text.strip():
                    res["message"] = out_text.strip()
                if err_text.strip():
                    res["error"] = err_text.strip()
        except Exception as e:  # noqa: BLE001 — service boundary
            res = {"id": job_id, "ok": False, "rc": 1, "error": str(e)}
        res["ms"] = round((time.perf_counter() - t0) * 1e3, 1)
        _respond(lock, real_out, res)

    # graceful shutdown: SIGTERM/SIGINT behave like `quit` (stop
    # reading, drain in-flight jobs, exit 0); restored on exit

    def _terminate(_sig, _frame):
        raise KeyboardInterrupt

    prev_term = None
    if threading.current_thread() is threading.main_thread():
        prev_term = signal.signal(signal.SIGTERM, _terminate)
    try:
        job_id = 0
        for raw in stdin:
            job_id += 1
            try:
                parts = shlex.split(raw, comments=True)
            except ValueError as e:
                _respond(lock, real_out,
                         {"id": job_id, "ok": False, "rc": 1, "error": f"bad line: {e}"})
                continue
            if not parts:
                job_id -= 1  # blank/comment lines don't consume an id
                continue
            cmd = parts[0]
            if cmd == "quit":
                break
            if cmd == "ping":
                _respond(lock, real_out, {"id": job_id, "ok": True, "pong": True})
                continue
            if cmd == "wait":
                drained, outstanding[:] = list(outstanding), []
                for fut in drained:
                    fut.result()
                res = {"id": job_id, "ok": True, "drained": len(drained)}
                if batcher is not None:
                    res["drained"] += batcher.drain()
                    res["waves"] = batcher.waves
                    res["failed_waves"] = batcher.failed_waves
                _respond(lock, real_out, res)
                continue
            if cmd in ("encode", "decode", "warm"):
                if cmd in ("encode", "decode") and len(parts) < 3:
                    _respond(lock, real_out, {
                        "id": job_id, "ok": False, "rc": 1,
                        "error": f"usage: {cmd} <in> <out> [flags...]",
                    })
                    continue
                if cmd == "encode" and batcher is not None:
                    batcher.submit(job_id, parts)
                    continue
                outstanding.append(pool.submit(handle, job_id, parts))
                if len(outstanding) > 4 * workers:  # keep the list bounded
                    outstanding[:] = [f for f in outstanding if not f.done()]
                continue
            _respond(lock, real_out,
                     {"id": job_id, "ok": False, "rc": 1,
                      "error": f"unknown command: {cmd}"})
    except (KeyboardInterrupt, BrokenPipeError):
        pass  # signal or client-gone: drain and exit cleanly below
    finally:
        if batcher is not None:
            batcher.close()  # process remaining queued encodes first
        pool.shutdown(wait=True)
        sys.stdout, sys.stderr = prev_out, prev_err
        if fd_saved is not None:
            try:
                real_out.flush()
                os.dup2(fd_saved, 1)  # restore the original stdout fd
            except OSError:
                pass
            real_out.close()  # closes fd_saved; fd 1 already restored
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
    return 0


if __name__ == "__main__":
    sys.exit(serve())
