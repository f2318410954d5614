"""The worked examples must actually run (docs/manual.md's companion)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quickstart_runs_end_to_end(tmp_path):
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join(
                   [REPO] + os.environ.get("PYTHONPATH", "").split(
                       os.pathsep)))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples",
                                      "quickstart.py"), "--cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "quickstart complete" in r.stdout
    assert "sharded render" in r.stdout
