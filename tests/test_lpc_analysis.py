"""LPC analysis unit layer (reference tests/test_lpc.cpp:100-195).

Property checks on ``ops/lpc.py`` over the reference test's signal
classes (noise / ramp / tone / near-silence), plus a quantized-
coefficient differential against the reference binary on edge signals —
the long-double parity risk called out in SURVEY §7.
"""

import subprocess

import numpy as np
import pytest

from lac_tpu.encoder import ChannelBlockEncoder
from lac_tpu.format import constants as C
from lac_tpu.ops import predictors

from .test_ladder import SHIM, shim  # noqa: F401 (fixture re-export)

N = 2048


def make_noise(n, amplitude):
    out = np.empty(n, np.int32)
    state = 1
    for i in range(n):
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        out[i] = np.int32(state >> 9) % amplitude
    return out


def make_ramp(n, amplitude):
    return ((amplitude * np.arange(n, dtype=np.int64)) // n).astype(np.int32)


def make_tone(n, freq, sr, amplitude):
    t = np.arange(n, dtype=np.float64) / sr
    return (np.sin(2 * np.pi * freq * t) * amplitude).astype(np.int32)


def make_near_silence(n):
    return (np.arange(n) % 7 == 0).astype(np.int32)


def _energy(v):
    return int(np.sum(np.abs(v.astype(np.int64))))


def _rice_bits(res):
    u = (np.abs(res.astype(np.int64)) * 2 - (res < 0)).astype(np.uint64)
    mean = (int(u.sum()) + len(u) // 2) // len(u)
    k = 0
    while (1 << k) < mean and k < 31:
        k += 1
    q = np.zeros_like(u) if k >= 31 else (u >> np.uint64(k))
    return int(q.sum()) + len(u) * (1 + k)


def _evaluate_orders(block):
    """Analog of evaluate_orders (test_lpc.cpp:69-99) on our analysis."""
    enc = ChannelBlockEncoder()
    coeffs, used, valid, mvo = enc._lpc_analysis(block[None, :], len(block))
    evals = []
    for li, cand in enumerate(C.LPC_ORDER_CANDIDATES):
        if cand > mvo or not valid[li, 0]:
            continue
        uo = int(used[li, 0])
        if uo < 4 or uo > 12:
            continue
        res, in_range = predictors.lpc_residual(block[None, :], coeffs[li], 12)
        assert bool(np.asarray(in_range)[0])
        res = np.asarray(res)[0]
        evals.append((uo, _rice_bits(res), _energy(res)))
    return evals


@pytest.mark.parametrize(
    "name,block",
    [
        ("white_noise", make_noise(N, 30000)),
        ("ramp", make_ramp(N, 50000)),
        ("tone", make_tone(N, 440.0, 48000, 40000)),
        ("near_silence", make_near_silence(N)),
    ],
)
def test_order_evaluation_quality(name, block):
    raw_energy = _energy(block)
    evals = _evaluate_orders(block)
    assert evals, "at least one LPC order should succeed"
    best = min(evals, key=lambda e: e[1])
    assert 4 <= best[0] <= 12
    if raw_energy > 0:
        assert best[2] <= raw_energy
    baseline = next(e for e in evals if e[0] == 4)
    tolerance = baseline[2] // 10 + 32
    for order, bits, energy in evals:
        assert 4 <= order <= 12 and bits > 0
        if raw_energy > 0:
            assert energy <= raw_energy
        if order > 4:
            assert energy <= baseline[2] + tolerance


# ----------------------------------------------------------- limb autocorr


def _limb_cases():
    rng = np.random.RandomState(0)
    return [
        ("i16_planes", rng.randint(-65535, 65536, (7, 16384)).astype(np.int32), 65535),
        ("ms_24bit", rng.randint(-(2**24 - 2), 2**24 - 1, (5, 16384)).astype(np.int32), 2**24 - 2),
        ("pos_boundary", np.full((2, 16384), 65535, np.int32), 65535),
        ("neg_boundary", np.full((2, 16384), -(2**24 - 2), np.int32), 2**24 - 2),
        ("alt_sign", np.where(np.arange(16384) % 2 == 0, 65535, -65535)[None].astype(np.int32), 65535),
        ("probe_len", rng.randint(-65535, 65536, (11, 256)).astype(np.int32), 65535),
        ("tiny_vals", rng.randint(-3, 4, (3, 16384)).astype(np.int32), 3),
        ("int16_dtype", rng.randint(-32768, 32768, (4, 4096)).astype(np.int16), 32767),
        ("full_scale_24bit", _full_scale(rng, 24), 1 << 23),
        ("full_scale_16bit", _full_scale(rng, 16), 1 << 15),
    ]


def _full_scale(rng, depth):
    """Full-scale PCM of one bit depth, boundary samples included: rows
    pinned at the negative and positive limits and alternating between
    them, then uniform noise over the whole range."""
    lo, hi = -(1 << (depth - 1)), (1 << (depth - 1)) - 1
    x = rng.randint(lo, hi + 1, (6, 16384)).astype(np.int32)
    x[0], x[1] = lo, hi
    x[2, ::2], x[2, 1::2] = lo, hi
    return x


@pytest.mark.parametrize("name,x,maxabs", _limb_cases(), ids=[c[0] for c in _limb_cases()])
def test_autocorrelation_limbs_exact(name, x, maxabs):
    """The 5-bit-limb MXU Gram formulation is bit-identical to the exact
    int64 lags (ops/lpc.py autocorrelation_limbs; reference lpc.cpp:80-96)
    on both backends, including domain boundaries."""
    from lac_tpu.ops import lpc as lpc_ops

    nl = lpc_ops.nlimbs_for_maxabs(maxabs)
    assert maxabs < 1 << (5 * nl - 1)
    ref = lpc_ops.autocorrelation(x.astype(np.int32), 12, xp=np)
    got_np = lpc_ops.autocorrelation_limbs(x, 12, nl, xp=np)
    assert np.array_equal(ref, got_np)
    import jax
    import jax.numpy as jnp

    got_jx = np.asarray(
        jax.jit(lambda a: lpc_ops.autocorrelation_limbs(a, 12, nl, xp=jnp))(x)
    )
    assert np.array_equal(ref, got_jx)


def test_nlimbs_for_maxabs():
    from lac_tpu.ops.lpc import nlimbs_for_maxabs

    assert nlimbs_for_maxabs(32767) == 4
    assert nlimbs_for_maxabs(65535) == 4
    assert nlimbs_for_maxabs((1 << 19) - 1) == 4  # top of the 4-limb domain
    assert nlimbs_for_maxabs(1 << 19) == 5
    assert nlimbs_for_maxabs((1 << 24) - 2) == 5
    assert nlimbs_for_maxabs(0) == 1


# ---------------------------------------------------------------- coeff diff


def _parse_lpc_header(block_bytes):
    """(order, coeffs int16 tuple) if the block chose LPC, else None."""
    if block_bytes[0] != C.PREDICTOR_LPC:
        return None
    order = block_bytes[1]
    coeffs = np.frombuffer(block_bytes[2 : 2 + 2 * order], dtype=">i2")
    return order, tuple(int(c) for c in coeffs)


def _edge_signals():
    """Signals that stress the 80-bit Levinson-Durbin parity: near-unit
    reflection coefficients, 24-bit amplitudes, near-singular lag
    matrices, DC offsets."""
    sigs = []
    t = np.arange(N, dtype=np.float64)
    big = (1 << 23) - 1
    sigs.append(("pure_tone_24bit", (np.sin(2 * np.pi * 0.003 * t) * big).astype(np.int32)))
    sigs.append(("two_tones", (np.sin(2 * np.pi * 0.011 * t) * 6e6
                               + np.sin(2 * np.pi * 0.0111 * t) * 6e6).astype(np.int32)))
    sigs.append(("dc_plus_lsb", (8_000_000 + (np.arange(N) % 3 == 0)).astype(np.int32)))
    sigs.append(("slow_chirp", (np.sin(2 * np.pi * (0.0005 + t / N * 0.002) * t) * big).astype(np.int32)))
    rng = np.random.RandomState(77)
    ar = np.zeros(N)
    e = rng.standard_normal(N)
    for i in range(2, N):
        ar[i] = 1.98 * ar[i - 1] - 0.9801 * ar[i - 2] + e[i]
    ar = ar / np.abs(ar).max() * big
    sigs.append(("near_unstable_ar2", ar.astype(np.int32)))
    for seed in range(6):
        r = np.random.RandomState(200 + seed)
        x = r.standard_normal(N)
        for _ in range(6):
            x = 0.9 * x + 0.1 * np.concatenate([[0.0], x[:-1]])
        sigs.append((f"smooth_noise_{seed}", (x / np.abs(x).max() * big * 0.9).astype(np.int32)))
    return sigs


def test_candidate_coeffs_differential(shim):  # noqa: F811
    """Whenever the reference picks LPC on an edge signal, our emitted
    block must match byte-for-byte — and the quantized Q15 coefficients
    extracted from both headers must be identical (the direct check on
    long-double Levinson-Durbin parity)."""
    enc = ChannelBlockEncoder()
    lpc_hits = 0
    for name, block in _edge_signals():
        ref = subprocess.run(
            [str(SHIM), "encode", "1", "1"],
            input=np.ascontiguousarray(block, np.int32).tobytes(),
            capture_output=True, check=True,
        ).stdout
        ours = enc.encode_group(block[None, :])[0]
        assert ours == ref, f"{name}: block bytes differ"
        parsed = _parse_lpc_header(ref)
        if parsed is not None:
            lpc_hits += 1
            assert _parse_lpc_header(ours) == parsed, f"{name}: coeffs differ"
    assert lpc_hits >= 4, f"edge corpus regressed: only {lpc_hits} LPC selections"
