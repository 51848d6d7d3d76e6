"""Device k-adaptation (``adapt.k_after_stateful`` with ``xp=jnp``) vs the
numpy closed form on adversarial inputs.

The numpy form is itself pinned against the scalar reference recursion
in test_adapt.py. The jitted form must be bit-identical on every input:
extreme codes, window boundaries, scan-tile straddles, long zero runs,
and the production 16384-sample width.
"""

import numpy as np

from lac_tpu.ops import adapt

_ROWS = 8


def check(u):
    import jax
    import jax.numpy as jnp

    u = np.asarray(u, np.uint32).astype(np.uint64)
    want = adapt.k_after_stateful(u, xp=np)
    got = np.asarray(jax.jit(lambda x: adapt.k_after_stateful(x, xp=jnp))(u))
    assert got.shape == want.shape
    mism = np.nonzero(got != want)
    if mism[0].size:
        r, c = mism[0][0], mism[1][0]
        raise AssertionError(
            f"first mismatch at ({r},{c}): got {got[r, c]} want {want[r, c]} "
            f"(u={u[r, max(0, c - 3):c + 1]})"
        )


def test_random_laplacian_rows():
    rng = np.random.RandomState(0)
    rows, n = _ROWS, 4096
    scales = np.exp(rng.uniform(np.log(1.5), np.log(5000), rows))
    res = rng.laplace(0, scales[:, None], (rows, n)).astype(np.int64)
    u = ((res.astype(np.uint32) << 1) ^ (res < 0).astype(np.uint32) * 0xFFFFFFFF)
    check(u)


def test_extreme_values_and_boundaries():
    rows, n = _ROWS, 4096
    u = np.zeros((rows, n), np.uint32)
    u[0, :] = 0xFFFFFFFF                     # max codes throughout
    u[1, ::2] = 0xFFFFFFFF                   # alternating max/zero
    u[2, :300] = 0xFFFFFFFF                  # drift window fill then silence
    u[3, 250:260] = 0x7FFFFFFF               # values straddling window fill
    u[4, :] = 1
    u[5, 90:100] = 0xFFFF0000                # micro-window boundary
    u[6, 2040:2060] = 0xDEADBEEF             # scan-tile boundary straddle
    u[7, :96] = 3                            # exactly the micro window
    check(u)


def test_window_edges_brute():
    # every count around the drift/micro window activations, with values
    # that flip the bias conditions near the thresholds
    rng = np.random.RandomState(1)
    rows, n = _ROWS, 2048
    u = rng.randint(0, 8, (rows, n)).astype(np.uint32)
    u[:, 100:140] = 0          # zero stretch (micro zero-bias region)
    u[:, 300:340] = rng.randint(1 << 20, 1 << 25, (rows, 40))
    check(u)


def test_tile_carry_consistency():
    # a max-code burst straddling the 4096 boundary of two 2048 scan tiles
    rng = np.random.RandomState(2)
    rows, n = _ROWS, 8192
    u = rng.randint(0, 1 << 16, (rows, n)).astype(np.uint32)
    u[:, 4000:4200] = 0xFFFFFFFF
    check(u)


def test_full_production_width():
    rng = np.random.RandomState(3)
    rows, n = _ROWS, 16384
    res = rng.laplace(0, 900, (rows, n)).astype(np.int64)
    u = ((res.astype(np.uint32) << 1) ^ (res < 0).astype(np.uint32) * 0xFFFFFFFF)
    u[:, 5000:5400] = 0
    u[0, :] = 0xFFFFFFFF  # all-max codes: the prefix sums' upper bound
    check(u)
