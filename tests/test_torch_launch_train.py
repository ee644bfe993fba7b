"""``python -m repro_torch.launch.train`` as a process on the CPU: it
trains, prints its loss lines and commits a checkpoint; the options that
are not ported exit non-zero with ``not ported yet``."""
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


@pytest.mark.parametrize("flag,milestone", [("--pod-compress", "M8b"),
                                            ("--production", "M7")])
def test_train_cli_refuses_what_is_not_ported(tmp_path, flag, milestone):
    out = _run(["--steps", "2", "--device", "cpu", "--ckpt-dir",
                str(tmp_path), flag])
    assert out.returncode != 0
    assert "not ported yet" in out.stderr and milestone in out.stderr
    assert not os.listdir(tmp_path)
