"""Training on a GPU: the tiny model's ``train_loss`` and gradients on the
card against the same model on the CPU (float32, ``rtol=2e-4, atol=2e-5``),
a few ``make_train_step`` steps on both, and one ``Trainer`` run on the card
with a checkpoint and a resume. Skipped where there is no CUDA device. It
imports no JAX, so it runs where only PyTorch is installed. Run on a GPU
machine with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_train_cuda.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import markov_batches
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as opt
from repro_torch.training import train_loop as tl

pytestmark = pytest.mark.gpu
TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _tiny(arch="granite-3-8b", **over):
    kw = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)
    kw.update(over)
    model = build_model(dataclasses.replace(
        get_config(arch, reduced=True), **kw))
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


def _on(tree, dev):
    return opt.tree_map(lambda t: t.to(dev), tree)


def _close(a, b):
    for x, y in zip(opt.tree_leaves(a), opt.tree_leaves(b)):
        torch.testing.assert_close(x.cpu().float(), y.cpu().float(), **TOL)


@pytest.mark.parametrize("arch,over", [
    ("granite-3-8b", {}),
    ("moonshot-v1-16b-a3b", {"n_kv_heads": 2})])
def test_train_loss_and_grads_on_the_card_equal_the_cpu(dev, arch, over):
    model, params = _tiny(arch, **over)
    batch = next(markov_batches(8, 16, 64, seed=1))
    cl, cm, cg = tl._value_and_grad(model.train_loss, params,
                                    tl.to_device(batch, "cpu"))
    gl, gm, gg = tl._value_and_grad(model.train_loss, _on(params, dev),
                                    tl.to_device(batch, dev))
    assert gl.is_cuda and all(g.is_cuda for g in opt.tree_leaves(gg))
    torch.testing.assert_close(gl.cpu(), cl, **TOL)
    torch.testing.assert_close(gm["moe_aux"].cpu(), cm["moe_aux"], **TOL)
    _close(gg, cg)


def test_train_steps_on_the_card_equal_the_cpu(dev):
    model, params = _tiny()
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=5)
    step = tl.make_train_step(model, ocfg)
    pc, oc = params, opt.adamw_init(params)
    pg, og = _on(params, dev), opt.adamw_init(_on(params, dev))
    assert og["step"].is_cuda and og["step"].dtype == torch.int32
    for batch in [b for b, _ in zip(markov_batches(8, 16, 64, seed=1),
                                    range(3))]:
        pc, oc, mc = step(pc, oc, tl.to_device(batch, "cpu"))
        pg, og, mg = step(pg, og, tl.to_device(batch, dev))
        for k in ("loss", "lr", "grad_norm"):
            assert mg[k].is_cuda
            torch.testing.assert_close(mg[k].cpu(), mc[k], rtol=1e-4, atol=0)
    _close(pg, pc)


def test_trainer_on_the_card_checkpoints_and_resumes(dev, tmp_path, capsys):
    model, params = _tiny()
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=12)
    cfg = tl.TrainerConfig(total_steps=6, checkpoint_every=3,
                           checkpoint_dir=str(tmp_path), log_every=1)
    tr = tl.Trainer(model, ocfg, cfg)
    assert tr.device.type == "cuda"
    p6, o6, info = tr.run(_on(params, dev), markov_batches(4, 16, 64,
                                                           seed=1))
    assert all(t.is_cuda for t in opt.tree_leaves(p6))
    assert int(o6["step"]) == 6 and len(info["history"]) == 6
    tr2 = tl.Trainer(model, ocfg, dataclasses.replace(cfg, total_steps=9))
    p9, o9, info2 = tr2.run(_on(params, dev), markov_batches(4, 16, 64,
                                                             seed=1))
    assert "resumed from step 6" in capsys.readouterr().out
    assert len(info2["history"]) == 3 and int(o9["step"]) == 9
    assert o9["step"].is_cuda and o9["step"].shape == ()
