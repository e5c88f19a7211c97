"""Doc-test of the example workflow: example/run_example.sh extracts and
executes every bash block of example/QUILT_usage.md (mirroring the
reference's example/run_example.sh doc-testing approach)."""
import os
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_example_workflow(tmp_path):
    # run from a scratch copy so example/data never pollutes the repo
    work = tmp_path / "repo"
    work.mkdir()
    (work / "example").mkdir()
    for f in ("QUILT_usage.md", "run_example.sh", "make_example_data.py"):
        shutil.copy(os.path.join(REPO, "example", f), work / "example" / f)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        ["bash", str(work / "example" / "run_example.sh")],
        cwd=work, env=env, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "example workflow OK" in r.stdout
