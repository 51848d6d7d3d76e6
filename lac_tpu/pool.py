"""Cross-file chunk pooling for many-file serving.

The reference's thread pool saturates every core with one-block tasks
regardless of which file a block came from (lac/encoder.cpp:259-443 —
the task queue holds (block index, both channels) items, provenance
never matters). The device-path equivalent is to fill K-wide device
chunks with 16384-sample blocks drawn from ALL queued files: one
:class:`~lac_tpu.device_pipeline.PlanePipeline` runs over the
concatenation of every file's full-block plane rows, so a batch of
short files sustains the same full-chunk rate as one long file instead
of each file ending on a padded partial chunk.

Byte parity is structural: every block's plan and emission read only
that block's own plane rows (plan_group is per-lane, stereo decisions
are per-block, chunk boundaries only affect batching shapes), so the
demultiplexed per-file payloads are identical to encoding each file
alone — asserted by tests/test_pool.py and live by scripts/bench_serve.

Two consumers:

- :func:`encode_pooled` — library batch API (``batch.encode_batch``
  with pooling);
- :func:`prepare_encode_job` + :func:`run_group_wave` — the serve
  batcher's split phases: prescreen/read jobs, pool compatible ones
  into waves, and release each file's plane results (via the pipeline's
  progress callback) while later chunks are still on the device.
"""

import os
from dataclasses import dataclass, field

import numpy as np

from .format import constants as C
from .ops._backend import is_jax

__all__ = ["PreparedEncode", "prepare_encode_job", "run_group_wave", "encode_pooled"]

# one wave's combined plane rows are host-resident for its lifetime;
# cap the width so a huge queue batches in bounded memory (4096 blocks
# = 256 MB of int16 stereo planes) — parity is unaffected (chunking
# never changes per-lane bytes)
_MAX_WAVE_BLOCKS = 4096


@dataclass(eq=False)
class PreparedEncode:
    """A serve encode job that can join a pooled device wave."""

    parts: list  # full job vector ["encode", in, out, flags...]
    in_path: str
    wav: tuple  # (left, right, channels, sample_rate, bit_depth)
    kind: str  # mono | lr | ms | auto
    nfull: int  # full 16384-sample blocks
    dt: object  # plane dtype (np.int16 for 16-bit content)
    key: tuple = field(default=())  # wave-compatibility group key
    opts: dict = field(default_factory=dict)
    effective_mode: int = 0


def prepare_encode_job(parts):
    """Prescreen one serve job vector for pooling.

    Returns a :class:`PreparedEncode` (WAV already read) when the job
    can join a pooled wave, else ``None`` — the caller then runs it
    through the ordinary CLI path, which reproduces every error
    message, debug print, and routing decision exactly.
    """
    from . import cli
    from .io import read_wav
    from .runtime.native import native_available
    from .utils.staged_output import paths_refer_to_same_file

    if len(parts) < 3 or parts[0] != "encode":
        return None
    in_path, out_path = parts[1], parts[2]
    opts = cli._parse_encode_flags(parts[3:])
    if opts is None:
        return None
    if (
        opts["debug_zr"]
        or opts["debug_lpc"]
        or opts["debug_stereo_est"]
        or opts["debug_partitions"]
        or opts["debug_threads"]
    ):
        # debug paths print per-block / per-encode data that a shared
        # wave would perturb (--debug-threads counts this job's own
        # emission workers; the wave emits with group[0]'s settings
        # before the collector resets) — keep them one-shot
        return None
    if paths_refer_to_same_file(in_path, out_path):
        return None
    if not is_jax(cli._encoder_xp()) or not native_available():
        return None  # pooling is a device-path optimization only
    try:
        stream_threshold = int(os.environ.get("LAC_TPU_STREAM_BLOCKS", "2048"))
    except ValueError:
        stream_threshold = 2048
    # scan before read (cli.py orders the same way): a file headed for
    # the bounded-memory streaming route must not be materialized whole
    # here first — that is the exact spike the route exists to prevent
    from .stream import scan_wav

    info = scan_wav(in_path)
    if info is None:
        return None
    nblocks = -(-info.frames // C.MAX_BLOCK_SIZE)
    if stream_threshold > 0 and nblocks >= stream_threshold:
        return None  # bounded-memory streaming route
    wav = read_wav(in_path)
    if wav is None:
        return None
    left, right, channels, sample_rate, bit_depth = wav
    nblocks = -(-len(left) // C.MAX_BLOCK_SIZE)
    nfull = nblocks - (1 if len(left) % C.MAX_BLOCK_SIZE else 0)
    if nfull < 1:
        return None
    effective_mode = 0 if channels == 1 else opts["stereo_mode"]
    kind = (
        "mono"
        if channels == 1
        else {C.STEREO_LR: "lr", C.STEREO_MS: "ms", C.STEREO_PER_BLOCK: "auto"}[
            effective_mode
        ]
    )
    dt = np.int16 if bit_depth == 16 else np.int32
    # jobs sharing a key can share one wave: same plane layout (kind,
    # dtype) and same plan semantics (partitioning; zero-run is always
    # on via the CLI). Sample rate / thread flags only affect headers /
    # host worker counts, never block bytes.
    key = (kind, np.dtype(dt).str, bool(opts["partitioning"]))
    prep = PreparedEncode(
        parts=list(parts), in_path=in_path, wav=wav, kind=kind, nfull=nfull, dt=dt
    )
    prep.key = key
    prep.opts = opts
    prep.effective_mode = effective_mode
    return prep


def _build_views(group):
    """Concatenate the group's full-block plane rows into one (total, N)
    matrix per channel; returns (lview, rview, spans)."""
    N = C.MAX_BLOCK_SIZE
    total = sum(j.nfull for j in group)
    dt = group[0].dt
    lview = np.empty((total, N), dt)
    rview = np.empty((total, N), dt) if group[0].kind != "mono" else None
    spans = []
    off = 0
    for j in group:
        left, right = j.wav[0], j.wav[1]
        # int32 -> int16 assignment is exact: WAV reads sign-extend into
        # the declared bit depth, so 16-bit content is in int16 range
        lview[off : off + j.nfull] = left[: j.nfull * N].reshape(j.nfull, N)
        if rview is not None:
            rview[off : off + j.nfull] = right[: j.nfull * N].reshape(j.nfull, N)
        spans.append((off, j.nfull))
        off += j.nfull
    return lview, rview, spans


def run_group_wave(group, file_done, template_enc=None):
    """Run ONE pooled device wave over every full block of ``group``
    (PreparedEncode items sharing ``.key``, or FrameEncoder-shaped
    items via ``template_enc``).

    ``file_done(i, (payloads, flags, uncertain))`` fires in group order
    as soon as file ``i``'s blocks have emitted — the pipeline finishes
    chunks in block order, so early files' host work (tail block, frame
    assembly, output write) overlaps later chunks' device compute.
    """
    from . import device_pipeline as DP

    lview, rview, spans = _build_views(group)
    total = lview.shape[0]
    if template_enc is None:
        import jax.numpy as jnp

        from .cli import _resolve_threads
        from .encoder import FrameEncoder
        from .parallel.mesh import default_mesh

        g0 = group[0]
        template_enc = FrameEncoder(
            12, g0.effective_mode, g0.wav[3], g0.wav[4], xp=jnp
        )
        template_enc.set_partitioning_enabled(bool(g0.opts["partitioning"]))
        template_enc.set_thread_count(_resolve_threads(g0.opts["thread_count"]))
        # pooled waves shard over the product-default mesh exactly like
        # one-shot CLI encodes (the reference's pool uses every core no
        # matter where blocks came from; bytes are sharding-invariant)
        mesh = default_mesh()
        if mesh is not None:
            template_enc.set_mesh(mesh)

    state = {"next": 0}

    def release(done, payloads, flags, uncertain):
        while state["next"] < len(spans):
            off, nf = spans[state["next"]]
            if off + nf > done:
                break
            pp = {b - off: payloads.pop(b) for b in range(off, off + nf)}
            fl = {b - off: flags.pop(b) for b in range(off, off + nf) if b in flags}
            un = {
                b - off: uncertain.pop(b)
                for b in range(off, off + nf)
                if b in uncertain
            }
            file_done(state["next"], (pp, fl, un))
            state["next"] += 1

    pipe = DP.PlanePipeline(
        template_enc, None, None, total, group[0].kind, views=(lview, rview)
    )
    pipe.run(progress_cb=release)
    DP.mark_warm()
    assert state["next"] == len(spans), "wave ended with unreleased files"


def split_waves(records, nfull_of=lambda r: r.nfull, max_blocks=None):
    """Split a compatible group into bounded-memory waves (greedy; a
    single file larger than the cap still forms its own wave)."""
    if max_blocks is None:
        max_blocks = _MAX_WAVE_BLOCKS  # read at call time: serve's
        # prescreen-residency cap reads the module attribute too
    waves, cur, blocks = [], [], 0
    for r in records:
        if cur and blocks + nfull_of(r) > max_blocks:
            waves.append(cur)
            cur, blocks = [], 0
        cur.append(r)
        blocks += nfull_of(r)
    if cur:
        waves.append(cur)
    return waves


def encode_pooled(items, sample_rate, bit_depth, stereo_mode=2, xp=None,
                  max_workers=4, **encoder_opts):
    """``batch.encode_batch`` with cross-file chunk pooling: the full
    16384-sample blocks of every item share device waves, so many short
    inputs encode at full-chunk throughput. Returns frames in order;
    bytes identical to per-item :meth:`FrameEncoder.encode`.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .encoder import FrameEncoder
    from .runtime.native import native_available

    if xp is None:
        xp = np
    items = [
        (np.ascontiguousarray(l, np.int32),
         np.ascontiguousarray(r if r is not None else np.empty(0, np.int32), np.int32))
        for l, r in items
    ]

    encs = []
    for left, right in items:
        enc = FrameEncoder(
            12, stereo_mode if len(right) else 0, sample_rate, bit_depth, xp=xp
        )
        for key, val in encoder_opts.items():
            getattr(enc, f"set_{key}")(val)
        # validate BEFORE any pooled device work: per-item encode()
        # rejects out-of-range PCM (reference lac/encoder.cpp:220-241),
        # and the pack24 upload truncates int32 planes to 24 bits — an
        # out-of-range 24-bit item must raise here, for every backend
        # identically, never reach the wave (advisor round-4 finding)
        if len(left):
            enc._validate(left, right)
        encs.append(enc)

    poolable = is_jax(xp) and native_available()
    groups = {}
    if poolable:
        mode_kind = {C.STEREO_LR: "lr", C.STEREO_MS: "ms", C.STEREO_PER_BLOCK: "auto"}
        for i, (left, right) in enumerate(items):
            if len(left) == 0:
                continue
            nblocks = -(-len(left) // C.MAX_BLOCK_SIZE)
            nfull = nblocks - (1 if len(left) % C.MAX_BLOCK_SIZE else 0)
            if nfull < 1:
                continue
            kind = "mono" if not len(right) else mode_kind[stereo_mode]
            prep = PreparedEncode(
                parts=[], in_path="", wav=(left, right, 0, sample_rate, bit_depth),
                kind=kind, nfull=nfull,
                dt=np.int16 if bit_depth == 16 else np.int32,
            )
            prep.key = (kind,)
            # mesh encoders pool with each other (the wave shards over
            # the template's mesh); mixing meshed and unmeshed items in
            # one wave would silently change the latter's device layout
            groups.setdefault((kind, id(encs[i].mesh)), []).append((i, prep))

    for (kind, _mid), pairs in groups.items():
        for wave in split_waves(pairs, nfull_of=lambda ip: ip[1].nfull):
            idxs = [i for i, _ in wave]

            def stash(j, planes, idxs=idxs):
                encs[idxs[j]]._injected_planes = planes

            run_group_wave([p for _, p in wave], stash, template_enc=encs[idxs[0]])

    def one(i):
        left, right = items[i]
        return encs[i].encode(left, right)

    if len(items) <= 1 or max_workers <= 1:
        return [one(i) for i in range(len(items))]
    with ThreadPoolExecutor(max_workers=min(max_workers, len(items))) as ex:
        return list(ex.map(one, range(len(items))))
