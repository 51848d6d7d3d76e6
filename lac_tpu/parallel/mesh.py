"""Multi-device scale-out: shard the block axis over a 1-D device mesh.

The codec's parallel unit is the 16384-sample channel block; blocks are
fully independent (v3 byte-bounded payloads — reference
docs/format.md:18-35), so the natural mapping is pure data parallelism
with **no collectives in the hot path**: each device plans its shard of
blocks, and the host gathers per-block token fields for packing. The
only cross-device traffic is an optional ``psum`` of aggregate
statistics (estimated payload bits). Every GPU of a host reaches every
other at the same NVLink rate, so the mesh stays 1-D.

This replaces the reference's worker thread pool
(lac/encoder.cpp:385-435) — parallelism is an array axis, not a queue.
"""

import functools
import os

import jax
import jax.numpy as jnp

from .. import configure_jax

configure_jax()
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..encoder import plan_group

BLOCK_AXIS = "blocks"


def make_mesh(devices=None):
    """1-D mesh over all (or the given) local devices."""
    devices = jax.devices() if devices is None else devices
    import numpy as np

    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


_DEFAULT_MESH_CACHE = []


def default_mesh():
    """The product-default mesh (CLI / serve / pooled serving): all local
    devices whenever more than one is present, mirroring the reference's
    use-everything worker pool (lac/encoder.cpp:385-435 — workers =
    min(hw, limit, blocks), with no opt-in flag). ``LAC_TPU_MESH=0``
    switches meshing off; ``LAC_TPU_MESH=1`` (the historical opt-in
    spelling) behaves the same as unset. Returns ``None`` when meshing
    is off or only one device exists. Sharding never changes bytes —
    the off switch exists for debugging, not correctness."""
    if os.environ.get("LAC_TPU_MESH", "1") == "0":
        return None
    if not _DEFAULT_MESH_CACHE:
        devs = jax.devices()
        _DEFAULT_MESH_CACHE.append(make_mesh(devs) if len(devs) > 1 else None)
    return _DEFAULT_MESH_CACHE[0]


@functools.lru_cache(maxsize=32)
def _sharded_plan_fn(mesh, n, zero_run_enabled, partitioning_enabled, emit_fields=True):

    def local(pcm, lpc_coeffs, lpc_valid):
        plan = plan_group(pcm, lpc_coeffs, lpc_valid, n, zero_run_enabled, partitioning_enabled, jnp,
                          emit_fields=emit_fields)
        # aggregate stat across devices (exercises a collective;
        # correctness never depends on it): total unary+field bits of
        # the compact ship buffer's token payloads — or, in metadata-only
        # replay mode, the psum'd count of planned lanes
        if emit_fields:
            shipv = plan["ship"].reshape(pcm.shape[0], n, 6)
            k = shipv[..., 5].astype(jnp.uint32)
            payload = (
                shipv[..., 0].astype(jnp.uint32)
                | (shipv[..., 1].astype(jnp.uint32) << jnp.uint32(8))
                | (shipv[..., 2].astype(jnp.uint32) << jnp.uint32(16))
                | (shipv[..., 3].astype(jnp.uint32) << jnp.uint32(24))
            )
            cls = shipv[..., 4] & jnp.uint8(7)
            rice_like = cls == 0
            approx = jnp.where(rice_like, (payload >> k) + k + jnp.uint32(1), jnp.uint32(2))
            local_bits = jnp.sum(approx.astype(jnp.uint64))
        else:
            local_bits = jnp.uint64(pcm.shape[0])
        plan["total_token_bits"] = jax.lax.psum(local_bits, BLOCK_AXIS)
        return plan

    in_specs = (P(BLOCK_AXIS), P(None, BLOCK_AXIS), P(None, BLOCK_AXIS))
    out_specs = {
        "ship": P(BLOCK_AXIS),
        "meta": P(BLOCK_AXIS),
        "total_token_bits": P(),
    }
    fn = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


def plan_group_sharded(mesh, pcm, lpc_coeffs, lpc_valid, n,
                       zero_run_enabled=True, partitioning_enabled=True,
                       emit_fields=True):
    """Run the full encode plan with the batch axis sharded over ``mesh``.

    ``pcm``: (B, n) with B divisible by the mesh size; LPC inputs as in
    :func:`lac_tpu.encoder.plan_group`. ``emit_fields=False`` returns
    plan metadata only (the native-replay product path).
    """
    fn = _sharded_plan_fn(mesh, n, bool(zero_run_enabled), bool(partitioning_enabled),
                          bool(emit_fields))
    sharding = NamedSharding(mesh, P(BLOCK_AXIS))
    pcm = jax.device_put(jnp.asarray(pcm), sharding)
    coeffs = jax.device_put(jnp.asarray(lpc_coeffs), NamedSharding(mesh, P(None, BLOCK_AXIS)))
    valid = jax.device_put(jnp.asarray(lpc_valid), NamedSharding(mesh, P(None, BLOCK_AXIS)))
    return fn(pcm, coeffs, valid)
