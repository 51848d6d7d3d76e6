"""lac_tpu — GPU-batched lossless audio codec.

A ground-up JAX/XLA re-architecture of the LAC codec (reference:
audexdev/Lossless-Audio-Codec, C++20 CLI). Produces byte-identical
``.lac`` v3 bitstreams while replacing the reference's per-sample
serial algorithms with batched array programs that run on the GPU:

* all candidate residuals, cost models, and Rice k-adaptation are
  computed as prefix-sum / sliding-window closed forms over thousands
  of blocks in flight (no per-sample feedback loop exists in the
  format's adaptation rule — see ``lac_tpu.ops.adapt``);
* bit emission is a prefix-sum + scatter bitpack over token arrays,
  or a native plan-replay when the C++ runtime is available;
* decode parses independent v3 block payloads in parallel and
  reconstructs PCM with batched restores.

Wire-format behavior is cited into the reference as ``file:line`` so
parity can be audited (e.g. docs/format.md, src/codec/block/encoder.cpp).

JAX is configured lazily (``configure_jax``) so pure-host paths — the
CLI decoder, WAV tools — never pay backend initialization.
"""

import os

__version__ = "0.2.1"

_JAX_CONFIGURED = False


def default_cache_dir():
    """The persistent compilation cache used when
    ``JAX_COMPILATION_CACHE_DIR`` is unset: ``.cache/jax`` in the
    checkout (listed in .gitignore)."""
    import pathlib

    return pathlib.Path(__file__).resolve().parent.parent / ".cache" / "jax"


def configure_jax():
    """Enable x64 (the codec is exact 64-bit integer arithmetic) and the
    persistent compilation cache. Called by every module that touches
    JAX, before any array is created."""
    global _JAX_CONFIGURED
    if _JAX_CONFIGURED:
        return
    import jax

    jax.config.update("jax_enable_x64", True)
    if os.environ.get("LAC_TPU_NO_CACHE") != "1":
        # JAX reads JAX_COMPILATION_CACHE_DIR itself; only when it is
        # unset does the cache go to the fixed in-checkout directory (a
        # path that moves between runs would never hit)
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", str(default_cache_dir()))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    _JAX_CONFIGURED = True
