"""The port's ``Trainer`` as the reference's trainer tests hold theirs:
it learns the Markov stream (``last < 0.7 * first`` and below ``0.8 *
ln(vocab)``), a preemption at step 3 commits exactly one checkpoint (step
4), a training process killed mid-run resumes from its newest checkpoint
and finishes, and ``StepMonitor`` flags the same steps as the reference's
on one timing sequence. CPU only (``device="cpu"``)."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro.runtime.monitor import StepMonitor as JaxStepMonitor
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.data.synthetic import markov_batches, synthetic_batches
from repro_torch.models.model import build_model
from repro_torch.runtime.monitor import StepMonitor
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_loop import Trainer, TrainerConfig

torch.set_num_threads(1)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


def _tiny_model():
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              dtype="float32", n_layers=2, d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                              vocab=64)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def test_trainer_learns_markov_stream(tmp_path):
    model, params = _tiny_model()
    tr = Trainer(model, AdamWConfig(lr=3e-3, warmup_steps=5, decay_steps=80),
                 TrainerConfig(total_steps=80, checkpoint_every=1000,
                               checkpoint_dir=str(tmp_path), log_every=1000,
                               async_checkpoint=False), device="cpu")
    params, opt, info = tr.run(params, markov_batches(8, 32, 64, seed=1))
    losses = info["history"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.7, f"no learning: {first:.3f} → {last:.3f}"
    assert last < np.log(64) * 0.8
    assert int(opt["step"]) == 80 and opt["step"].dtype == torch.int32
    # the end-of-run checkpoint restores into the same structure
    rp, ro, step = Checkpointer(str(tmp_path)).restore_latest(
        template=(params, opt), device="cpu")
    assert step == 80 and ro["step"].dtype == torch.int32
    assert ro["step"].ndim == 0 and int(ro["step"]) == 80
    torch.testing.assert_close(rp["stack"]["list"][1]["b0"]["ffn"]["wi"]["w"],
                               params["stack"]["list"][1]["b0"]["ffn"]["wi"]
                               ["w"], rtol=0, atol=0)


def test_preemption_checkpoint(tmp_path):
    """SIGTERM-style preemption: the trainer commits a checkpoint and
    exits."""
    model, params = _tiny_model()
    tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=0),
                 TrainerConfig(total_steps=100, checkpoint_every=1000,
                               checkpoint_dir=str(tmp_path),
                               async_checkpoint=False, log_every=50),
                 device="cpu")

    def hook(step, p, m):
        if step == 3:
            tr._preempted = True    # simulate SIGTERM delivery

    _, _, info = tr.run(params, synthetic_batches(4, 16, 64), step_hook=hook)
    assert Checkpointer(str(tmp_path)).list_steps() == [4]
    assert len(info["history"]) == 4


def test_sigterm_sets_preemption_in_the_main_thread(tmp_path):
    import signal
    model, params = _tiny_model()
    tr = Trainer(model, AdamWConfig(), TrainerConfig(
        checkpoint_dir=str(tmp_path)), device="cpu")
    old = signal.getsignal(signal.SIGTERM)
    try:
        tr._install_signal_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert tr._preempted
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("previous", ["python", "not_from_python"])
def test_run_puts_the_previous_sigterm_handler_back(tmp_path, monkeypatch,
                                                    previous):
    """After ``run`` the handler before it is back; where ``signal.signal``
    reported None (a handler not installed from Python) that is the
    default action, not the trainer's handler."""
    import signal
    model, params = _tiny_model()
    tr = Trainer(model, AdamWConfig(), TrainerConfig(
        total_steps=1, checkpoint_dir=str(tmp_path), log_every=100),
        device="cpu")
    real = signal.signal
    calls = []

    def before(signum, frame):
        pass

    def fake(signum, handler):
        calls.append(handler)
        prev = real(signum, handler)
        return None if previous == "not_from_python" else prev

    old = real(signal.SIGTERM, before)
    try:
        monkeypatch.setattr(signal, "signal", fake)
        tr.run(params, synthetic_batches(4, 16, 64))
        monkeypatch.undo()
        assert len(calls) == 2 and calls[0] not in (before, signal.SIG_DFL)
        want = before if previous == "python" else signal.SIG_DFL
        assert calls[1] is want and signal.getsignal(signal.SIGTERM) is want
    finally:
        real(signal.SIGTERM, old)


def test_resume_continues_from_the_checkpoint(tmp_path):
    """A second trainer on the same directory restores params, moments and
    the step counter and runs only the steps left."""
    model, params = _tiny_model()
    cfg = TrainerConfig(total_steps=6, checkpoint_every=3,
                        checkpoint_dir=str(tmp_path), log_every=100,
                        async_checkpoint=True)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0)
    full, full_opt, _ = Trainer(model, ocfg, dataclasses.replace(
        cfg, checkpoint_dir=str(tmp_path / "full")), device="cpu").run(
            params, markov_batches(4, 16, 64, seed=2))
    Trainer(model, ocfg, dataclasses.replace(cfg, total_steps=3),
            device="cpu").run(params, markov_batches(4, 16, 64, seed=2))
    it = markov_batches(4, 16, 64, seed=2)
    for _ in range(3):
        next(it)
    p, o, info = Trainer(model, ocfg, cfg, device="cpu").run(
        params, it, opt_state=adamw_init(params))
    assert len(info["history"]) == 3 and int(o["step"]) == 6
    torch.testing.assert_close(p["embedding"]["embedding"],
                               full["embedding"]["embedding"], rtol=0, atol=0)
    torch.testing.assert_close(o["v"]["final_norm"]["gain"],
                               full_opt["v"]["final_norm"]["gain"], rtol=0,
                               atol=0)


_TRAIN_SCRIPT = textwrap.dedent("""
    import sys, dataclasses
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import markov_batches
    from repro_torch.models.model import build_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import Trainer, TrainerConfig

    cfg = get_config("granite-3-8b", reduced=True)
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=2, d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                              vocab=64)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tr = Trainer(model, AdamWConfig(lr=1e-3, warmup_steps=0),
                 TrainerConfig(total_steps={steps}, checkpoint_every=5,
                               checkpoint_dir={ckpt!r}, log_every=1,
                               async_checkpoint=False), device="cpu")
    params, opt, info = tr.run(params, markov_batches(4, 16, cfg.vocab,
                                                      seed=1))
    print("FINAL_STEP", len(info["history"]), int(opt["step"]), flush=True)
""")


def test_kill_and_restart_resumes(tmp_path):
    """Fault tolerance: kill training mid-run; a restart resumes from the
    newest committed checkpoint and finishes."""
    ckpt = str(tmp_path / "ckpt")
    script = _TRAIN_SCRIPT.format(src=SRC, ckpt=ckpt, steps=40)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 120
    saw_step = False
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if "step 12" in line:
                saw_step = True
                break
            if proc.poll() is not None:
                break
    finally:
        proc.kill()
        proc.wait()
    assert saw_step, "training never reached step 12"
    steps = Checkpointer(ckpt).list_steps()
    assert steps and steps[-1] >= 5
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300)
    assert f"resumed from step {steps[-1]}" in out.stdout, out.stdout[-2000:]
    assert f"FINAL_STEP {40 - steps[-1]} 40" in out.stdout, out.stdout[-2000:]


@pytest.mark.parametrize("factor,warmup", [(3.0, 2), (2.0, 3), (1.5, 1)])
def test_straggler_monitor_flags_as_the_reference(factor, warmup):
    rng = np.random.default_rng(0)
    times = list(0.1 + 0.02 * rng.random(40))
    for i in (5, 11, 12, 30):
        times[i] = 0.1 * (2 + i % 7)
    a, b = StepMonitor(factor, warmup=warmup), JaxStepMonitor(factor,
                                                              warmup=warmup)
    flags = [(a.record(t), b.record(t)) for t in times]
    assert [x for x, _ in flags] == [y for _, y in flags]
    assert a.flagged == b.flagged and a.flagged
    assert a.ewma == b.ewma


def test_straggler_monitor():
    mon = StepMonitor(factor=3.0, warmup=2)
    for _ in range(10):
        mon.record(0.1)
    assert not mon.flagged
    assert mon.record(1.0)          # 10× EWMA → flagged
    e = mon.ewma
    mon.record(0.1)
    assert abs(mon.ewma - e) < 0.05  # a straggler does not poison the EWMA


def test_trainer_defaults_to_the_cuda_device():
    model, _ = _tiny_model()
    if torch.cuda.is_available():
        tr = Trainer(model, AdamWConfig(), TrainerConfig())
        assert tr.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            Trainer(model, AdamWConfig(), TrainerConfig())
