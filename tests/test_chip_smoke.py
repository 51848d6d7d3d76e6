"""chip_smoke.py must refuse to run anywhere but on a GPU with the repo."""

import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("where", ["cpu_platform", "script_alone"])
def test_chip_smoke_fails_without_gpu(tmp_path, where):
    env = dict(os.environ)
    if where == "cpu_platform":
        env["JAX_PLATFORMS"] = "cpu"
        script, cwd = ROOT / "chip_smoke.py", ROOT
    else:  # no accelerator here, and none of the repo beside the script
        env.pop("JAX_PLATFORMS", None)
        env.pop("PYTHONPATH", None)
        script = tmp_path / "chip_smoke.py"
        shutil.copy(ROOT / "chip_smoke.py", script)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
