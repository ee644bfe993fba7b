"""Port vs reference: ``LM.train_loss`` and ``training/train_loop``'s
``make_train_step`` on ``tests/test_training.py``'s tiny model (float32).
The reference model is initialised with ``jax.random``, fetched to the host
and carried across with ``convert.from_jax_params`` (its AdamW state too).

Tolerances: the loss within ``rtol=1e-5`` and the gradients within
``rtol=2e-4, atol=2e-5`` of ``jax.value_and_grad`` of the reference's
(the reference's own tolerance for updates in
``test_microbatched_step_matches_full_batch``); train steps: losses within
``rtol=1e-4``, and params and AdamW moments within ``rtol=1e-4`` plus an
``atol`` of ``1e-5`` times each leaf's RMS (a leaf's elements near zero
carry the absolute error of its typical elements); the MoE aux loss within
``rtol=1e-5``.

The reference decays every leaf of two or more dimensions in its layout:
stacked (``scan_layers`` and more than one period) a norm gain carries the
layer axis and decays, unrolled it does not. The port decays as the
reference does for the same config, and the step tests run both layouts
at the default weight decay."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import markov_batches, synthetic_batches
from repro.models.model import build_model as jax_build_model
from repro.training import optimizer as jopt
from repro.training.train_loop import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol_rms=1e-5)
TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)


def _pair(arch="granite-3-8b", scan_layers=True, **over):
    kw = dict(TINY, **over)
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               scan_layers=scan_layers, **kw)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               scan_layers=scan_layers, **kw)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.device_get(jparams), device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _batches(vocab, n, gen=markov_batches, b=8, s=16):
    return [bt for bt, _ in zip(gen(b, s, vocab, seed=1), range(n))]


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return tloop.to_device(b, "cpu")


def _close_trees(jtree, ttree, rtol, atol=0.0, atol_rms=0.0):
    """A reference tree (stacked or not) against a port tree, leaf by leaf
    in the port's (unrolled) structure; each leaf's atol is ``atol`` plus
    ``atol_rms`` times the reference leaf's RMS."""
    want = convert.from_jax_params(jax.device_get(jtree), device="cpu")
    lw, lt = topt.tree_leaves(want), topt.tree_leaves(ttree)
    assert len(lw) == len(lt)
    for a, b in zip(lw, lt):
        assert a.shape == b.shape and a.dtype == b.dtype
        a = a.float().numpy()
        rms = float(np.sqrt(np.mean(np.square(a))))
        np.testing.assert_allclose(b.detach().float().numpy(), a, rtol=rtol,
                                   atol=atol + atol_rms * rms)


@pytest.mark.parametrize("gen", [markov_batches, synthetic_batches],
                         ids=["markov", "random"])
def test_train_loss_and_grads_match_reference(gen):
    jm, jp, tm, tp = _pair()
    batch = _batches(tm.cfg.vocab, 1, gen)[0]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, _jb(batch))
    tl, tmet, tg = tloop._value_and_grad(tm.train_loss, tp, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(tmet["xent"]), float(jmet["xent"]),
                               rtol=1e-5, atol=0)
    assert float(tmet["moe_aux"]) == float(jmet["moe_aux"]) == 0.0
    _close_trees(jg, tg, **GRAD_TOL)


def test_label_mask_matches_reference():
    jm, jp, tm, tp = _pair()
    batch = dict(_batches(tm.cfg.vocab, 1)[0])
    batch["labels"] = batch["labels"].copy()
    batch["labels"][:, :5] = -1
    jl, _ = jm.train_loss(jp, _jb(batch))
    tl, _ = tm.train_loss(tp, _tb(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)


def test_forward_train_records_autograd_and_serving_does_not():
    _, _, tm, tp = _pair()
    p = topt.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    toks = torch.zeros((1, 4), dtype=torch.int64)
    logits, caches = tm.forward(p, {"tokens": toks}, mode="train")
    assert logits.requires_grad and caches is None
    cache = tm.init_cache(1, 8, device="cpu")
    logits, _ = tm.forward(p, {"tokens": toks}, mode="prefill", caches=cache)
    assert not logits.requires_grad


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
@pytest.mark.parametrize("clip", [1.0, None])
def test_five_train_steps_match_reference(clip, scan_layers):
    """At the default weight decay (0.1), in the reference's stacked and
    unrolled layouts: the norm gains decay in the first only."""
    jm, jp, tm, tp = _pair(scan_layers=scan_layers)
    ocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=5,
                            clip_norm=clip)
    jstep = jax.jit(jax_make_train_step(jm, ocfg))
    tstep = tloop.make_train_step(tm, topt.AdamWConfig(**ocfg.__dict__))
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for batch in _batches(tm.cfg.vocab, 5):
        jp, js, jmet = jstep(jp, js, _jb(batch))
        tp, ts, tmet = tstep(tp, ts, _tb(batch))
        for k in ("loss", "xent", "lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, atol=0, err_msg=k)
        _close_trees(jp, tp, **STEP_TOL)
    assert sorted(tmet) == sorted(jmet)
    assert int(ts["step"]) == 5 and ts["step"].dtype == torch.int32


def test_continues_a_reference_run_from_its_converted_state():
    """The reference runs 3 steps; the port takes its params and AdamW state
    (stacked ``periods`` moments unrolled) and runs step 4, which agrees
    with the reference's own step 4 at the default weight decay (the
    stacked layout decays the norm gains, and so does the port)."""
    jm, jp, tm, _ = _pair()
    ocfg = jopt.AdamWConfig(lr=3e-3, warmup_steps=2, decay_steps=10)
    assert ocfg.weight_decay == 0.1
    jstep = jax.jit(jax_make_train_step(jm, ocfg))
    js = jopt.adamw_init(jp)
    batches = _batches(tm.cfg.vocab, 4)
    for batch in batches[:3]:
        jp, js, _ = jstep(jp, js, _jb(batch))
    assert "periods" in js["m"]["stack"]
    tp = convert.from_jax_params(jax.device_get(jp), device="cpu")
    ts = convert.from_jax_params(jax.device_get(js), device="cpu")
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 3
    assert "list" in ts["m"]["stack"] and "list" in ts["v"]["stack"]
    jp4, js4, jmet = jstep(jp, js, _jb(batches[3]))
    tstep = tloop.make_train_step(tm, topt.AdamWConfig(**ocfg.__dict__))
    tp4, ts4, tmet = tstep(tp, ts, _tb(batches[3]))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-4, atol=0)
    _close_trees(jp4, tp4, **STEP_TOL)
    _close_trees(js4["m"], ts4["m"], **STEP_TOL)
    _close_trees(js4["v"], ts4["v"], **STEP_TOL)


@pytest.mark.parametrize("micro", [2, 4])
def test_microbatched_step_matches_full_batch(micro):
    _, _, tm, tp = _pair()
    ocfg = topt.AdamWConfig(warmup_steps=0, clip_norm=None, weight_decay=0.0)
    batch = _tb(_batches(tm.cfg.vocab, 1, synthetic_batches)[0])
    opt = topt.adamw_init(tp)
    p1, _, m1 = tloop.make_train_step(tm, ocfg)(tp, opt, batch)
    pm, _, mm = tloop.make_train_step(tm, ocfg, microbatches=micro)(
        tp, opt, batch)
    np.testing.assert_allclose(float(mm["loss"]), float(m1["loss"]),
                               rtol=1e-5, atol=0)
    for a, b in zip(topt.tree_leaves(p1), topt.tree_leaves(pm)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def test_microbatched_grads_are_float32_means_and_last_metrics():
    _, _, tm, tp = _pair()
    batch = _tb(_batches(tm.cfg.vocab, 1)[0])
    loss, metrics, grads = tloop._accumulate_grads(tm.train_loss, tp, batch,
                                                   2)
    halves = [{k: v[i * 4:(i + 1) * 4] for k, v in batch.items()}
              for i in range(2)]
    parts = [tloop._value_and_grad(tm.train_loss, tp, h) for h in halves]
    np.testing.assert_allclose(float(loss),
                               float((parts[0][0] + parts[1][0]) / 2),
                               rtol=1e-6)
    assert float(metrics["xent"]) == float(parts[1][1]["xent"])
    for g, a, b in zip(topt.tree_leaves(grads), topt.tree_leaves(parts[0][2]),
                       topt.tree_leaves(parts[1][2])):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, (a + b) / 2, rtol=0, atol=0)


def test_remat_changes_memory_not_numbers():
    """Gradients with each period recomputed in the backward pass equal
    those with its activations kept."""
    _, _, tm, tp = _pair()
    batch = _tb(_batches(tm.cfg.vocab, 1)[0])
    outs = {}
    for remat in (True, False):
        m = build_model(dataclasses.replace(tm.cfg, remat=remat))
        outs[remat] = tloop._value_and_grad(m.train_loss, tp, batch)
    assert float(outs[True][0]) == float(outs[False][0])
    for a, b in zip(topt.tree_leaves(outs[True][2]),
                    topt.tree_leaves(outs[False][2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_runs_each_period_under_checkpoint(monkeypatch):
    import torch.utils.checkpoint as ckpt
    _, _, tm, tp = _pair()
    calls = []
    real = ckpt.checkpoint

    def counted(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", counted)
    batch = _tb(_batches(tm.cfg.vocab, 1)[0])
    tloop._value_and_grad(tm.train_loss, tp, batch)
    assert calls == [False] * tm.cfg.n_layers
    calls.clear()
    with torch.no_grad():
        tm.train_loss(tp, batch)            # no autograd: nothing to save
    assert calls == []


def test_moe_aux_matches_reference():
    """A reduced moonshot (4 experts, top-2): ``moe_aux`` within 1e-5 of the
    reference's, the loss ``xent + 0.01 * aux``, and the gradients close."""
    jm, jp, tm, tp = _pair("moonshot-v1-16b-a3b", n_kv_heads=2)
    assert tm.cfg.moe.n_experts == 4 and tm.cfg.moe.top_k == 2
    batch = _batches(tm.cfg.vocab, 1)[0]
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, _jb(batch))
    tl, tmet, tg = tloop._value_and_grad(tm.train_loss, tp, _tb(batch))
    aux = float(tmet["moe_aux"])
    assert aux > 0
    np.testing.assert_allclose(aux, float(jmet["moe_aux"]), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(tl), float(tmet["xent"]) + 0.01 * aux,
                               rtol=1e-6, atol=0)
    _close_trees(jg, tg, **GRAD_TOL)


def test_not_ported_options_raise():
    _, _, tm, tp = _pair()
    with pytest.raises(NotImplementedError, match="not ported yet.*M8b"):
        tloop.make_train_step(tm, topt.AdamWConfig(), pod_compress=True)
    with pytest.raises(NotImplementedError, match="not ported yet.*M7"):
        tloop.make_train_step(tm, topt.AdamWConfig(), mesh=object())
    with pytest.raises(NotImplementedError, match="not ported yet.*M8b"):
        tloop.init_pod_error(tp, 2)
