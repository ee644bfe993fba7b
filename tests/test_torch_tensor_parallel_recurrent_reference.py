"""The port's tensor-parallel mamba and rwkv against the reference's own
forward and train step under its mesh: the reference's jitted
``model.forward`` (prefill), ``value_and_grad`` of ``train_loss`` and its
jitted train step, with ``make_param_shardings`` on a (2, 2) ('data',
'model') host mesh of four XLA CPU devices (this file's own
``multidevice_run`` subprocess, GSPMD partitioning the mixers by the
reference's rules), and the port's on a (data 2, model 2) mesh of four
gloo ranks (``in_proj``'s paired cut, ``x_proj`` row-parallel, jamba's
MoE expert-parallel and routed over both 'data' ranks at
``capacity_factor`` 1.0), on the same parameters
(``convert.from_jax_params`` of the reference's jitted ``init``, saved
by the subprocess): reduced jamba
and reduced rwkv (``torch_recurrent_tp_workers``) over 16-token sequences
(two chunks of the chunked scan and of the chunkwise WKV). Logits within
1e-5, the loss within 1e-5 relative, the gradients within ``GRAD_TOL``
(``tests/test_torch_train_step.py``), the step's loss and grad norm within
1e-5 and 1e-4 relative; the same step from ``fsdp_place``'s layout (FSDP
over 'data') held to the same reference outputs."""
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_recurrent_tp_workers as W
from repro_torch import convert
from repro_torch.distributed.group import run_local

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
KINDS = W.KINDS

_REFERENCE = textwrap.dedent(f"""
    import warnings; warnings.filterwarnings("ignore")
    import sys
    sys.path.insert(0, TESTS)
    import numpy as np, jax, jax.numpy as jnp
    from repro.data.synthetic import markov_batches
    from repro.distributed.compat import activate_mesh, make_mesh
    from repro.distributed.sharding import make_param_shardings
    from repro.models.model import build_model
    from repro.training.optimizer import AdamWConfig, adamw_init
    from repro.training.train_loop import make_train_step
    import torch_recurrent_tp_workers as W
    mesh = make_mesh((2, 2), ("data", "model"))
    activate_mesh(mesh)

    def run(cfg, pre, s):
        model = build_model(cfg)
        params = jax.jit(model.init)(jax.random.PRNGKey(0))
        params = jax.device_put(params, make_param_shardings(mesh, params))
        batch = {{k: jnp.asarray(v) for k, v in
                 next(markov_batches(8, s, cfg.vocab, seed=1)).items()}}
        toks = batch["tokens"]
        logits = jax.jit(lambda p, t, c: model.forward(
            p, {{"tokens": t}}, mode="prefill", caches=c)[0])(
            params, toks, model.init_cache(*toks.shape))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.train_loss, has_aux=True))(params, batch)
        _, _, met = jax.jit(make_train_step(model, AdamWConfig()))(
            params, adamw_init(params), batch)
        leaves = jax.tree_util.tree_leaves(jax.device_get(grads))
        pleaves = jax.tree_util.tree_leaves(jax.device_get(params))
        out = dict(tokens=np.asarray(toks), labels=np.asarray(
            batch["labels"]), logits=np.asarray(logits),
            loss=np.asarray(loss), step_loss=np.asarray(met["loss"]),
            step_grad_norm=np.asarray(met["grad_norm"]),
            **{{f"g{{i}}": np.asarray(g) for i, g in enumerate(leaves)}},
            **{{f"p{{i}}": np.asarray(p) for i, p in enumerate(pleaves)}})
        return {{pre + k: v for k, v in out.items()}}

    np.savez(OUT, **{{k: v for kind in W.KINDS for k, v in run(
        W.reference_config(kind, jax=True), kind + "_",
        W.TRAIN_SEQ).items()}})
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The subprocess's results, by kind, and its directory."""
    import os
    from conftest import run_multidevice_script
    d = tmp_path_factory.mktemp("rec_ref")
    out = str(d / "reference.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    run_multidevice_script(f"OUT = {out!r}\nTESTS = {tests!r}\n"
                           + _REFERENCE, devices=4, timeout=600)
    ref = dict(np.load(out))
    return {kind: {k[len(kind) + 1:]: v for k, v in ref.items()
                   if k.startswith(kind + "_")} for kind in KINDS}, d


def _port_tree(kind, ref, prefix):
    """The reference's tree of ``prefix``-numbered leaves of ``ref`` (its
    params or gradients) carried over to the port."""
    from repro.models.model import build_model
    treedef = jax.tree_util.tree_structure(jax.eval_shape(
        build_model(W.reference_config(kind, jax=True)).init,
        jax.random.PRNGKey(0)))
    return convert.from_jax_params(jax.tree_util.tree_unflatten(
        treedef, [ref[f"{prefix}{i}"] for i in range(treedef.num_leaves)]),
        device="cpu")


@pytest.fixture(scope="module")
def both(reference):
    """Each kind's reference results, wanted gradients and the port's (one
    ``run_local`` for both, on the reference's ``init`` saved by the
    subprocess)."""
    refs, d = reference
    cases, want = {}, {}
    for kind in KINDS:
        r = refs[kind]
        path = str(d / f"{kind}_params.pt")
        torch.save(_port_tree(kind, r, "p"), path)
        cases[kind] = (path, r["tokens"], {"tokens": r["tokens"],
                                           "labels": r["labels"]})
        want[kind] = {k: v.numpy() for k, v in
                      W.TPW._leaves(_port_tree(kind, r, "g"))}
    port = run_local(W.reference_ranks, 4, backend="gloo", device="cpu",
                     args=(cases,), timeout=600, store_dir=str(d))[0]
    return {k: (refs[k], want[k], port[k]) for k in KINDS}


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_logits_match_reference(both, kind):
    ref, _, port = both[kind]
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_grads_match_reference(both, kind):
    ref, want, port = both[kind]
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(port["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(port["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_train_step_metrics_match_reference(both, kind):
    ref, _, port = both[kind]
    np.testing.assert_allclose(port["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_fsdp_step_matches_reference(both, kind):
    """The same step from ``fsdp_place``'s layout (FSDP over 'data': the
    reference's ``make_param_shardings`` puts 'data' on the same dims but
    for ``x_proj``, which the port's row-parallel cut moves to its output
    dim): the loss within 1e-5 relative, the gradients within
    ``GRAD_TOL``, the step's loss and grad norm within 1e-5 and 1e-4
    relative of the reference's GSPMD run."""
    ref, want, port = both[kind]
    got = port["fsdp"]
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)
