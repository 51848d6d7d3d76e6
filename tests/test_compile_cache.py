"""Persistent compile cache location (lac_tpu.configure_jax)."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import jax, lac_tpu
lac_tpu.configure_jax()
print(jax.config.jax_compilation_cache_dir)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(jax.numpy.arange(7)).block_until_ready()
"""


def _probe(env):
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300, check=True)
    return proc.stdout.strip().splitlines()[-1]


def test_cache_honors_env_dir(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jc"))
    env.pop("LAC_TPU_NO_CACHE", None)
    assert _probe(env) == str(tmp_path / "jc")
    assert any((tmp_path / "jc").iterdir()), "no executable landed in the cache dir"


def test_cache_default_is_fixed_checkout_path():
    import lac_tpu

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("LAC_TPU_NO_CACHE", None)
    want = ROOT / ".cache" / "jax"
    assert lac_tpu.default_cache_dir() == want
    assert _probe(env) == str(want)
