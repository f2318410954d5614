"""The persistent compile cache: JAX_COMPILATION_CACHE_DIR wins, otherwise
a fixed git-ignored directory in the checkout."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = ("import jax\n"
         "from deepmimo_tpu.utils.compile_cache import enable_compile_cache\n"
         "print(enable_compile_cache())\n"
         "print(jax.config.jax_compilation_cache_dir)\n")


@pytest.mark.parametrize("env_dir", [None, "from_env"])
def test_enable_compile_cache(env_dir, tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["PYTHONPATH"] = REPO
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=str(tmp_path),
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    used, configured = r.stdout.split()[-2:]
    expect = (str(tmp_path / env_dir) if env_dir
              else os.path.join(REPO, ".jax_cache"))
    assert used == configured == expect
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
