import os

# Tests run on CPU with a virtual 8-device mesh so multi-device sharding
# logic is exercised without accelerators. The config update covers a
# pytest plugin having imported jax before this file set the variable.
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import lac_tpu  # noqa: E402

lac_tpu.configure_jax()
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

# COVERAGE NOTE: the plane pipeline's production chunk widths (128/256
# blocks) would take tens of minutes to compile a (128, 16384) planner
# on one CPU core — the suite pins a small width instead. The pipeline
# logic is width-independent and byte parity is asserted throughout;
# the production (128/256, 16384) executables themselves are exercised
# on the GPU by `python chip_smoke.py`, and on the CPU by the slow
# smoke test (LAC_TPU_SLOW=1 python -m pytest
# tests/test_device_pipeline.py -k production_shape).
os.environ.setdefault("LAC_TPU_CHUNK_BLOCKS", "16")

import pathlib
import subprocess

import pytest

REFERENCE_CLI = pathlib.Path(__file__).resolve().parent.parent / ".refbuild" / "lac_cli"


@pytest.fixture(scope="session")
def reference_cli():
    """Path to the reference encoder binary, or skip if unavailable."""
    if not REFERENCE_CLI.exists():
        pytest.skip("reference lac_cli binary not built (.refbuild)")
    return str(REFERENCE_CLI)


def run_reference(args, **kw):
    return subprocess.run([str(REFERENCE_CLI), *args], capture_output=True, **kw)
