"""The port's tensor-parallel forward and train step against the
reference's own under its mesh: the reference's jitted ``model.forward``
(prefill) and ``value_and_grad`` of ``train_loss`` and its jitted train
step, with ``make_param_shardings`` on a (2, 2) ('data', 'model') host
mesh of four XLA CPU devices (one ``multidevice_run`` subprocess, GSPMD
partitioning at its ``shard_act`` points), and the port's on a (data 2,
model 2) mesh of four gloo ranks, on the same parameters
(``convert.from_jax_params`` of the reference's ``init``): logits within
1e-5, the loss within 1e-5 relative, the gradients within ``GRAD_TOL``
(``tests/test_torch_train_step.py``), the step's loss and grad norm within
1e-5 and 1e-4 relative. The same subprocess runs reduced moonshot (4
experts, top-2, ``capacity_factor`` 1.0 so capacity binds), which the
port runs expert-parallel over 'model' and routed over both 'data' ranks
together (``torch_ep_workers.reference_moe_ranks``), held to the same
tolerances."""
import dataclasses
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_ep_workers as EP
import torch_tp_workers as W
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import convert
from repro_torch.distributed.group import run_local

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
_OVER = dict(W.TP_TINY, **W.TRAIN_OVER)
_MOE_OVER = dict(EP.TRAIN_OVER)

_REFERENCE = textwrap.dedent(f"""
    import warnings; warnings.filterwarnings("ignore")
    import dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.data.synthetic import markov_batches
    from repro.distributed.compat import activate_mesh, make_mesh
    from repro.distributed.sharding import make_param_shardings
    from repro.models.model import build_model
    from repro.training.optimizer import AdamWConfig, adamw_init
    from repro.training.train_loop import make_train_step
    mesh = make_mesh((2, 2), ("data", "model"))
    activate_mesh(mesh)

    def run(cfg, pre):
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        params = jax.device_put(params, make_param_shardings(mesh, params))
        batch = {{k: jnp.asarray(v) for k, v in
                 next(markov_batches(8, 16, cfg.vocab, seed=1)).items()}}
        toks = batch["tokens"]
        logits = jax.jit(lambda p, t, c: model.forward(
            p, {{"tokens": t}}, mode="prefill", caches=c)[0])(
            params, toks, model.init_cache(*toks.shape))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.train_loss, has_aux=True))(params, batch)
        _, _, met = jax.jit(make_train_step(model, AdamWConfig()))(
            params, adamw_init(params), batch)
        leaves = jax.tree_util.tree_leaves(jax.device_get(grads))
        out = dict(tokens=np.asarray(toks), labels=np.asarray(
            batch["labels"]), logits=np.asarray(logits),
            loss=np.asarray(loss), step_loss=np.asarray(met["loss"]),
            step_grad_norm=np.asarray(met["grad_norm"]),
            **{{f"g{{i}}": np.asarray(g) for i, g in enumerate(leaves)}})
        return {{pre + k: v for k, v in out.items()}}

    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **{_OVER!r})
    moe = get_config("moonshot-v1-16b-a3b", reduced=True)
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor={EP.BINDING_CF!r}), **{_MOE_OVER!r})
    np.savez(OUT, **run(cfg, ""), **run(moe, "moe_"))
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The subprocess's results (granite's keys, moonshot's under
    ``moe_``) and its directory."""
    from conftest import run_multidevice_script
    d = tmp_path_factory.mktemp("tp_ref")
    out = str(d / "reference.npz")
    run_multidevice_script(f"OUT = {out!r}\n" + _REFERENCE, devices=4,
                           timeout=600)
    return dict(np.load(out)), d


def _want_grads(jparams, ref, pre=""):
    treedef = jax.tree_util.tree_structure(jparams)
    jgrads = jax.tree_util.tree_unflatten(
        treedef, [ref[f"{pre}g{i}"] for i in range(treedef.num_leaves)])
    return {k: v.numpy() for k, v in W._leaves(
        convert.from_jax_params(jgrads, device="cpu"))}


@pytest.fixture(scope="module")
def both(reference):
    ref, d = reference
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                               **_OVER)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.device_get(jparams), device="cpu")
    path = str(d / "params.pt")
    torch.save(tparams, path)
    want_grads = _want_grads(jparams, ref)
    port = run_local(W.reference_ranks, 4, backend="gloo", device="cpu",
                     args=(path, ref["tokens"], {"tokens": ref["tokens"],
                                                 "labels": ref["labels"]}),
                     timeout=600, store_dir=str(d))[0]
    return ref, want_grads, port


@pytest.fixture(scope="module")
def moe_both(reference):
    ref, d = reference
    ref = {k[4:]: v for k, v in ref.items() if k.startswith("moe_")}
    path = str(d / "moe_params.pt")
    _, jparams, _ = EP.reference_params(_MOE_OVER, EP.BINDING_CF, path)
    port = run_local(EP.reference_moe_ranks, 4, backend="gloo",
                     device="cpu", args=(path, ref["tokens"],
                                         {"tokens": ref["tokens"],
                                          "labels": ref["labels"]}),
                     timeout=600, store_dir=str(d))[0]
    return ref, _want_grads(jax.device_get(jparams), ref), port


def test_prefill_logits_match_reference(both):
    ref, _, port = both
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)


def test_loss_and_grads_match_reference(both):
    ref, want, port = both
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(port["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(port["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


def test_train_step_metrics_match_reference(both):
    ref, _, port = both
    np.testing.assert_allclose(port["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)


def test_moe_prefill_logits_match_reference(moe_both):
    ref, _, port = moe_both
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)


def test_moe_loss_and_grads_match_reference(moe_both):
    ref, want, port = moe_both
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(port["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(port["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


def test_moe_train_step_metrics_match_reference(moe_both):
    ref, _, port = moe_both
    np.testing.assert_allclose(port["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)
