"""``chip_smoke.py`` refuses to run without a GPU: non-zero exit and no
``ok`` line, both with JAX on the CPU and in a directory that holds the
script alone."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_smoke(cwd, extra_env):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)


@pytest.mark.parametrize("where", ["checkout", "script-alone"])
def test_smoke_fails_without_gpu(where, tmp_path):
    if where == "checkout":
        cwd, env = REPO, {"JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO}
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, env = str(tmp_path), {"JAX_PLATFORMS": "cpu"}
    res = run_smoke(cwd, env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_main_path_runs_without_flax():
    """The machine with the card may lack Flax: with it blocked, the
    pipeline, bench and the smoke's selftest phase still import and run."""
    code = (
        "import sys; sys.modules['flax'] = None\n"
        "import caelo_tpu.pipeline, bench, chip_smoke\n"
        "from caelo_tpu.config import small_test_config\n"
        "out = chip_smoke.phase_selftest(small_test_config())\n"
        "assert out['passed'], out\n"
        "assert 'flax' not in [m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None]\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
