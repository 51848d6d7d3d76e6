"""Row-scan kernels (ops/pallas_kernels.py, Triton in interpret mode) and
the XLA scans and reductions that stay beside them, against numpy."""

import functools

import numpy as np
import pytest

from lac_tpu.encoder import _k_costs_stack
from lac_tpu.ops import adapt, pallas_kernels as PK, runs


def _u32(rng, shape):
    return rng.randint(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def test_split_cumsums_tile_carry():
    """Four 2048-column tiles: the running sums carry across every tile
    boundary; all-max codes reach the largest prefix sums."""
    import jax.numpy as jnp

    rng = np.random.RandomState(5)
    u = _u32(rng, (3, 4 * PK._TILE))
    u[0] = 0xFFFFFFFF
    u[1, PK._TILE - 3 : PK._TILE + 3] = 0xFFFF0000  # straddles tile 0/1
    hi, lo = PK.split_cumsums_u32(jnp.asarray(u), interpret=True)
    np.testing.assert_array_equal(np.asarray(hi), np.cumsum(u >> 16, -1, dtype=np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), np.cumsum(u & 0xFFFF, -1, dtype=np.uint32))


def test_cumsum_packed_flags_and_lead_shapes():
    """The packed flag counters (two 16-bit halves) over an odd number
    of rows in a 3-D lead shape: one program per row, no row padding."""
    import jax.numpy as jnp

    rng = np.random.RandomState(9)
    flags = rng.randint(0, 2, (3, 5, 2 * PK._TILE)).astype(np.uint32)
    packed = flags + (rng.randint(0, 2, flags.shape).astype(np.uint32) << 16)
    got = np.asarray(PK.cumsum_u32(jnp.asarray(packed), interpret=True))
    assert got.shape == packed.shape
    np.testing.assert_array_equal(got, np.cumsum(packed, -1, dtype=np.uint32))


def test_kernel_choice_by_platform_and_shape(monkeypatch):
    import jax

    assert not PK.kernel_applicable(16384)  # CPU backend: XLA's cumsum
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert PK.kernel_applicable(16384)
    assert PK.kernel_applicable(2 * PK._TILE)
    assert not PK.kernel_applicable(256)  # stereo-probe lanes stay XLA
    assert not PK.kernel_applicable(PK._TILE + 128)


def test_k_after_stateful_through_kernels(monkeypatch):
    """The GPU route of k_after_stateful (both scans in the kernels) is
    bit-identical to the numpy closed form."""
    import jax.numpy as jnp

    monkeypatch.setattr(PK, "kernel_applicable", lambda n: n % PK._TILE == 0)
    monkeypatch.setattr(PK, "split_cumsums_u32",
                        functools.partial(PK.split_cumsums_u32, interpret=True))
    monkeypatch.setattr(PK, "cumsum_u32", functools.partial(PK.cumsum_u32, interpret=True))
    rng = np.random.RandomState(2)
    res = rng.laplace(0, 700, (2, 3, 2 * PK._TILE)).astype(np.int64)
    u = ((res.astype(np.uint32) << 1) ^ (res < 0).astype(np.uint32) * 0xFFFFFFFF)
    u[0, 0] = 0xFFFFFFFF
    u[1, 2, 1000:1400] = 0
    want = adapt.k_after_stateful(u.astype(np.uint64), xp=np)
    got = np.asarray(adapt.k_after_stateful(jnp.asarray(u.astype(np.uint64)), xp=jnp))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("which", ["prefix_max", "suffix_min"])
def test_zero_breaks_jnp_matches_numpy(which):
    """zero_breaks' XLA scans (cummax / reverse cummin) at the production
    width, with runs at both edges and an all-zero row."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(13)
    z = rng.rand(6, 16384) < 0.7
    z[0] = True
    z[1, :500] = True
    z[1, -500:] = True
    z[2] = False
    want = runs.zero_breaks(z, xp=np)
    got = jax.jit(lambda a: runs.zero_breaks(a, xp=jnp))(z)
    k = 0 if which == "prefix_max" else 1
    np.testing.assert_array_equal(np.asarray(got[k]), want[k])


def test_k_costs_stack_jnp_extreme_codes():
    """The 17 fused k-cost reductions on extreme u32 codes: all-max rows
    drive every 16-bit-half partial sum to its bound."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(17)
    u = _u32(rng, (4, 3, 16384))
    u[0] = 0xFFFFFFFF
    u[1] = 0
    u[2, 0] = 0xFFFF
    u[2, 1] = 0x10000
    want = _k_costs_stack(u.astype(np.uint64), 16, np)
    got = jax.jit(lambda a: _k_costs_stack(a, 16, jnp))(u)
    np.testing.assert_array_equal(np.asarray(got), want)
