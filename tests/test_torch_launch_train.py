"""``python -m repro_torch.launch.train`` as a process on the CPU: it
trains, prints its loss lines and commits a checkpoint; ``--pod-compress``
alone trains plainly and ``--production`` needs the production mesh's
256 ranks."""
import os
import subprocess
import sys

import pytest

from repro_torch.checkpoint import Checkpointer

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _run(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC + (
        os.pathsep + os.environ["PYTHONPATH"]
        if os.environ.get("PYTHONPATH") else ""))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                          + args, capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_train_cli_trains_and_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    out = _run(["--arch", "granite-3-8b", "--reduced", "--steps", "6",
                "--device", "cpu", "--ckpt-dir", ckpt])
    assert out.returncode == 0, out.stderr[-2000:]
    assert "[trainer] step 0 loss" in out.stdout, out.stdout
    assert "[train] done: loss" in out.stdout and "(6 steps" in out.stdout
    assert Checkpointer(ckpt).list_steps() == [6]


@pytest.mark.parametrize("flag", ["--pod-compress", "--production"])
def test_train_cli_mesh_options(tmp_path, flag):
    """``--pod-compress`` alone trains plainly (no 'pod' axis to compress
    over); ``--production`` builds the 16x16 production mesh over the
    group's ranks and so fails on one, as the reference's does."""
    ckpt = str(tmp_path / "ckpt")
    out = _run(["--steps", "2", "--device", "cpu", "--ckpt-dir", ckpt, flag])
    if flag == "--pod-compress":
        assert out.returncode == 0, out.stderr[-2000:]
        assert "[train] done: loss" in out.stdout and "(2 steps" in out.stdout
        assert Checkpointer(ckpt).list_steps() == [2]
    else:
        assert out.returncode != 0
        assert "needs 256 ranks, the group has 1" in out.stderr
        assert not os.path.exists(ckpt) or not os.listdir(ckpt)
