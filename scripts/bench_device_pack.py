"""Measure the device bitpack prototype vs the native host packer.

Answers SURVEY C1 / round-2 verdict item 6: is on-device token-body
packing competitive with the host emitter on this hardware? Times, for
a production-shaped chunk (LANES x 16384 adaptive-Rice lanes):

  device: one jit computing zigzag -> stateful k-sequence -> Rice
          elements -> packed u32 words on the device, then the D2H
          fetch of the packed words (the transfer a product
          integration would pay),
  host:   the native BitSink packer (lac_pack_streams) packing the
          same token streams from precomputed element arrays, and the
          end-to-end native plane emitter for context.

Byte parity of every lane against bitio.pack.pack_stream is asserted.

Run on the GPU:           python scripts/bench_device_pack.py
Force CPU for a smoke:    JAX_PLATFORMS=cpu LANES=8 python scripts/bench_device_pack.py
"""

import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

LANES = int(os.environ.get("LANES", "256"))
N = 16384
INITIAL_K = 4


def make_lanes(seed=5):
    rng = np.random.RandomState(seed)
    # Laplacian residuals with lane-varying scale, like LPC output
    scales = np.exp(rng.uniform(np.log(2), np.log(400), LANES))
    res = rng.laplace(0, scales[:, None], (LANES, N)).astype(np.int64)
    return np.clip(res, -(1 << 22), (1 << 22) - 1).astype(np.int32)


def main():
    from lac_tpu import configure_jax

    configure_jax()
    import jax
    import jax.numpy as jnp

    from lac_tpu.bitio.pack import pack_stream
    from lac_tpu.ops import adapt, device_pack as dp

    res = make_lanes()

    # host-side element construction (shared ground truth)
    u_np = dp.zigzag(res, xp=np)
    ka = adapt.k_after_stateful(u_np, xp=np)
    ku = adapt.k_used_from_after(ka, INITIAL_K, xp=np)
    un_np, fv_np, fl_np = dp.rice_elements(u_np, ku, xp=np)
    max_bits = int((un_np + fl_np).sum(axis=1).max())
    W = dp.words_capacity(max_bits)
    print(f"lanes={LANES} n={N} max_lane_bits={max_bits} W={W} "
          f"fetch_bytes={LANES * W * 4}")

    # ---------------- device: tokenize + pack in one jit --------------
    @jax.jit
    def device_emit(res_d):
        u = dp.zigzag(res_d, xp=jnp)
        ka = adapt.k_after_stateful(u, xp=jnp)
        ku = adapt.k_used_from_after(ka, jnp.int32(INITIAL_K), xp=jnp)
        return dp.pack_rice_lanes(u, ku, W, xp=jnp)

    words, tb = device_emit(res)  # compile
    words.block_until_ready()
    dev_best = comp_best = host_best = float("inf")
    for i in range(4):
        fresh = res.copy()
        fresh[:, i] ^= 1  # fresh content per timed pass
        t0 = time.perf_counter()
        w2, t2 = device_emit(fresh)
        wh = np.asarray(w2)  # forces execution + D2H of the words
        th = np.asarray(t2)
        dt = time.perf_counter() - t0
        dev_best = min(dev_best, dt)
    fresh_w = fresh  # the content wh/th were computed from
    for i in range(4):
        fresh = res.copy()
        fresh[:, i] ^= 3
        t0 = time.perf_counter()
        w2, t2 = device_emit(fresh)
        np.asarray(t2)  # tiny fetch forces execution without the words
        comp_best = min(comp_best, time.perf_counter() - t0)
    samples = LANES * N

    # parity: every lane bit-identical to the vectorized host packer
    u_f = dp.zigzag(fresh_w, xp=np)
    ka_f = adapt.k_after_stateful(u_f, xp=np)
    ku_f = adapt.k_used_from_after(ka_f, INITIAL_K, xp=np)
    un_f, fv_f, fl_f = dp.rice_elements(u_f, ku_f, xp=np)
    for b in range(0, LANES, max(1, LANES // 16)):
        ref = pack_stream(un_f[b], fv_f[b].astype(np.uint64), fl_f[b])
        nb = (int(th[b]) + 7) // 8
        got = wh[b].astype(">u4").tobytes()[:nb]
        assert got == ref, f"lane {b} parity FAILED"
    print("parity OK (device words == host pack_stream)")

    # ---------------- host: native batched packer, same elements ------
    from lac_tpu.runtime.native import pack_streams_native

    offs = np.arange(LANES + 1, dtype=np.uint64) * np.uint64(N)
    un_c = un_np.reshape(-1).astype(np.uint32)
    fv_c = fv_np.reshape(-1)
    fl_c = fl_np.reshape(-1).astype(np.uint8)
    if pack_streams_native(un_c, fv_c, fl_c, offs) is not None:
        for _ in range(3):
            t0 = time.perf_counter()
            pack_streams_native(un_c, fv_c, fl_c, offs)
            host_best = min(host_best, time.perf_counter() - t0)
    else:
        print("native packer unavailable; host timing skipped")

    print(f"device tokenize+pack+fetch: {dev_best * 1e3:8.1f} ms "
          f"({samples / dev_best / 1e6:6.1f} Msamp/s)")
    print(f"device tokenize+pack only:  {comp_best * 1e3:8.1f} ms "
          f"(words fetch adds {(dev_best - comp_best) * 1e3:.1f} ms)")
    if host_best < float("inf"):
        print(f"host native pack (from elements): {host_best * 1e3:8.1f} ms "
              f"({samples / host_best / 1e6:6.1f} Msamp/s)")
    print(f"packed payload: {int(np.asarray(tb).sum()) // 8 / 1e6:.2f} MB dense, "
          f"fetched (padded) {LANES * W * 4 / 1e6:.2f} MB")


if __name__ == "__main__":
    main()
