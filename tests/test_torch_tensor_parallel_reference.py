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
together (``torch_ep_workers.reference_moe_ranks``), reduced minicpm3
(MLA: its latent down-projections column-parallel and gathered, its heads
over 'model'), and reduced mixtral with 8 q / 4 KV heads on sequences of
48 tokens past its 32-token window (expert-parallel, routed over both
'data' ranks, ``capacity_factor`` 1.0), all held to the same tolerances
(``torch_mla_ring_workers.reference_ranks``). On a (1, 4) mesh of the
same four devices it runs granite's model with 8 q / 2 KV heads, and with
6 q / 2 KV and ``d_ff`` 130 (``torch_tp_workers.REF_GROUP_OVER``), which
it cuts inside a head; the port runs them on replica groups on (data 1,
model 4), held to the same tolerances. On that mesh it also runs
reduced moonshot with 6 experts, which 'model' 4 does not divide: the
reference cuts its banks' 'expert_ff' dim (``wdown`` on its output), the
port every expert's FFN columns (``wdown`` row-parallel); and reduced
seamless over random frames (``torch_tp_workers.REF_MODEL4_OVER``'s
encoder-decoder: its encoder and cross-attention on 2 of 8 heads a rank,
the head replicated), both held to the same tolerances."""
import dataclasses
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_ep_workers as EP
import torch_mla_ring_workers as MR
import torch_tp_workers as W
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import convert
from repro_torch.distributed.group import run_local

GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
_OVER = dict(W.TP_TINY, **W.TRAIN_OVER)
_MOE_OVER = dict(EP.TRAIN_OVER)
_RING_OVER = dict(MR.RING_TINY, vocab=MR.TRAIN_VOCAB)

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

    def run(cfg, pre, s=16, m=None):
        if m is not None:
            activate_mesh(m)
        mesh = m or globals()["mesh"]
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        params = jax.device_put(params, make_param_shardings(mesh, params))
        batch = {{k: jnp.asarray(v) for k, v in
                 next(markov_batches(8, s, cfg.vocab, seed=1)).items()}}
        extra = {{}}
        if cfg.is_encdec:            # random frames, s / 4 of them
            extra["enc_frames"] = jnp.asarray(np.random.default_rng(
                5).standard_normal((8, s // 4, cfg.d_model)).astype(
                np.float32))
            batch.update(extra)
        toks = batch["tokens"]
        logits = jax.jit(lambda p, t, e, c: model.forward(
            p, {{"tokens": t, **e}}, mode="prefill", caches=c)[0])(
            params, toks, extra, model.init_cache(*toks.shape))
        (loss, _), grads = jax.jit(jax.value_and_grad(
            model.train_loss, has_aux=True))(params, batch)
        _, _, met = jax.jit(make_train_step(model, AdamWConfig()))(
            params, adamw_init(params), batch)
        leaves = jax.tree_util.tree_leaves(jax.device_get(grads))
        out = dict(tokens=np.asarray(toks), labels=np.asarray(
            batch["labels"]), logits=np.asarray(logits),
            **{{k: np.asarray(v) for k, v in extra.items()}},
            loss=np.asarray(loss), step_loss=np.asarray(met["loss"]),
            step_grad_norm=np.asarray(met["grad_norm"]),
            **{{f"g{{i}}": np.asarray(g) for i, g in enumerate(leaves)}})
        return {{pre + k: v for k, v in out.items()}}

    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **{_OVER!r})
    moe = get_config("moonshot-v1-16b-a3b", reduced=True)
    moe = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, capacity_factor={EP.BINDING_CF!r}), **{_MOE_OVER!r})
    mla = dataclasses.replace(get_config("minicpm3-4b", reduced=True),
                              **{MR.REF_OVER!r})
    ring = get_config("mixtral-8x7b", reduced=True)
    ring = dataclasses.replace(ring, moe=dataclasses.replace(
        ring.moe, capacity_factor={MR.BINDING_CF!r}), **{_RING_OVER!r})
    out = dict(**run(cfg, ""), **run(moe, "moe_"),
               **run(mla, "mla_", {MR.REF_SEQ["mla"]!r}),
               **run(ring, "ring_", {MR.REF_SEQ["ring"]!r}))
    # heads (and an FFN width) 'model' 4 does not divide: the reference
    # cuts the flattened heads * head_dim dim, inside a head, on a (1, 4)
    # mesh of the same four devices; and the encoder-decoder there
    mesh14 = make_mesh((1, 4), ("data", "model"))
    for name, over in {W.REF_MODEL4_OVER!r}.items():
        over = dict(over)
        base = dataclasses.replace(get_config(
            over.pop("arch", "granite-3-8b"), reduced=True), **{_OVER!r})
        out.update(run(dataclasses.replace(base, **over),
                       "grp_" + name + "_", m=mesh14))
    # experts 'model' 4 does not divide: the 'expert_ff' fallback
    out.update(run(dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, n_experts={EP.FF_EXPERTS!r})), "moeff_", m=mesh14))
    np.savez(OUT, **out)
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
def port(reference):
    """The wanted results and the port's, for every model of the
    subprocess, from one set of four gloo rank processes
    (``torch_tp_workers.reference_all_ranks``): granite's (and the
    (1, 4) models') under ``"tp"``, moonshot's (and the 'expert_ff'
    fallback's) under ``"moe"``, minicpm3's and the ring's under
    ``"mr"``."""
    ref, d = reference
    # granite on (2, 2), and the (1, 4) models
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                               **_OVER)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.device_get(jparams), device="cpu")
    path = str(d / "params.pt")
    torch.save(tparams, path)
    want_grads = _want_grads(jparams, ref)
    groups, group_want = {}, {}
    for name, over in W.REF_MODEL4_OVER.items():
        pre = f"grp_{name}_"
        r = {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}
        over = dict(over)
        gcfg = dataclasses.replace(jax_get_config(
            over.pop("arch", "granite-3-8b"), reduced=True), **_OVER)
        gparams = jax_build_model(dataclasses.replace(
            gcfg, **over)).init(jax.random.PRNGKey(0))
        gpath = str(d / f"grp_{name}_params.pt")
        torch.save(convert.from_jax_params(jax.device_get(gparams),
                                           device="cpu"), gpath)
        groups[name] = (gpath, r["tokens"], {
            k: r[k] for k in ("tokens", "labels", "enc_frames") if k in r})
        group_want[name] = (r, _want_grads(gparams, ref, pre))
    tp_args = (path, ref["tokens"], {"tokens": ref["tokens"],
                                     "labels": ref["labels"]}, groups)
    # moonshot on (2, 2), and 6 experts on (1, 4)
    moe_ref = {k[4:]: v for k, v in ref.items() if k.startswith("moe_")}
    ff_ref = {k[6:]: v for k, v in ref.items() if k.startswith("moeff_")}
    moe_path = str(d / "moe_params.pt")
    _, moe_jparams, _ = EP.reference_params(_MOE_OVER, EP.BINDING_CF,
                                            moe_path)
    ff_path = str(d / "moeff_params.pt")
    _, ff_jparams, _ = EP.reference_params(_MOE_OVER, EP.BINDING_CF, ff_path,
                                           experts=EP.FF_EXPERTS)
    moe_args = (moe_path, moe_ref["tokens"],
                {"tokens": moe_ref["tokens"], "labels": moe_ref["labels"]},
                (ff_path, ff_ref["tokens"], {"tokens": ff_ref["tokens"],
                                             "labels": ff_ref["labels"]}))
    # minicpm3 and the ring on (2, 2)
    cases, mr_refs, mr_want = {}, {}, {}
    for kind in ("mla", "ring"):
        r = {k[len(kind) + 1:]: v for k, v in ref.items()
             if k.startswith(kind + "_")}
        mpath = str(d / f"{kind}_params.pt")
        mjparams = MR.reference_params(kind, mpath)
        cases[kind] = (mpath, r["tokens"], {"tokens": r["tokens"],
                                            "labels": r["labels"]})
        mr_refs[kind] = r
        mr_want[kind] = _want_grads(jax.device_get(mjparams), r)
    tp, moe, mr = run_local(W.reference_all_ranks, 4, backend="gloo",
                            device="cpu", args=(tp_args, moe_args, (cases,)),
                            timeout=900, store_dir=str(d))[0]
    return {"tp": (ref, want_grads, tp, group_want),
            "moe": (moe_ref, _want_grads(jax.device_get(moe_jparams),
                                         moe_ref), moe,
                    {"ff": (ff_ref, _want_grads(jax.device_get(ff_jparams),
                                                ff_ref), moe["ff"])}),
            "mr": {k: (mr_refs[k], mr_want[k], mr[k]) for k in cases}}


@pytest.fixture(scope="module")
def both(port):
    return port["tp"]


@pytest.fixture(scope="module")
def moe_both(port):
    """Reduced moonshot's (4 experts on (2, 2)) reference results, wanted
    gradients and the port's; under ``"ff"`` the same for 6 experts on (1,
    4), the 'expert_ff' fallback."""
    return port["moe"]


@pytest.fixture(scope="module")
def mla_ring_both(port):
    """Reduced minicpm3's and the ring's reference results, wanted
    gradients and the port's, by kind."""
    return port["mr"]


def test_prefill_logits_match_reference(both):
    ref, _, port, _ = both
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)


def test_loss_and_grads_match_reference(both):
    ref, want, port, _ = both
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(port["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(port["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


def test_train_step_metrics_match_reference(both):
    ref, _, port, _ = both
    np.testing.assert_allclose(port["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)


@pytest.mark.parametrize("name", list(W.REF_GROUP_OVER))
def test_replica_group_forward_and_grads_match_reference(both, name):
    """8 q / 2 KV heads, and 6 q / 2 KV with ``d_ff`` 130, on (data 1,
    model 4): the reference cuts inside a head (GSPMD), the port runs
    replica groups; the prefill logits within 1e-5, the loss within 1e-5
    relative, the gradients within ``GRAD_TOL``."""
    _, _, port, group_want = both
    ref, want = group_want[name]
    got = port["groups"][name]
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(got["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(W.REF_GROUP_OVER))
def test_replica_group_train_step_metrics_match_reference(both, name):
    _, _, port, group_want = both
    ref, _ = group_want[name]
    got = port["groups"][name]["step"]
    np.testing.assert_allclose(got["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)


def test_moe_prefill_logits_match_reference(moe_both):
    ref, _, port, _ = moe_both
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)


def test_moe_loss_and_grads_match_reference(moe_both):
    ref, want, port, _ = moe_both
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(port["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(port["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


def test_moe_train_step_metrics_match_reference(moe_both):
    ref, _, port, _ = moe_both
    np.testing.assert_allclose(port["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)


def _held_to_reference(ref, want, got):
    """Prefill logits within 1e-5, the loss within 1e-5 relative, the
    gradients within ``GRAD_TOL``, the step's loss and grad norm within
    1e-5 and 1e-4 relative."""
    np.testing.assert_allclose(got["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)
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


def test_expert_ff_matches_reference(moe_both):
    """6 experts on (data 1, model 4): the reference's 'expert_ff'
    fallback (GSPMD) against the port's every-expert FFN-column cut."""
    _held_to_reference(*moe_both[3]["ff"])


def test_encdec_matches_reference(both):
    """The encoder-decoder on (data 1, model 4) over random frames: the
    reference's GSPMD forward, gradients and step against the port's
    encoder and cross-attention on this rank's heads."""
    _, _, port, group_want = both
    ref, want = group_want["encdec"]
    assert any(k.startswith("encoder/") for k in want)
    _held_to_reference(ref, want, port["groups"]["encdec"])


@pytest.mark.parametrize("kind", ["mla", "ring"])
def test_mla_ring_prefill_logits_match_reference(mla_ring_both, kind):
    ref, _, port = mla_ring_both[kind]
    np.testing.assert_allclose(port["logits"], ref["logits"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["mla", "ring"])
def test_mla_ring_loss_and_grads_match_reference(mla_ring_both, kind):
    ref, want, port = mla_ring_both[kind]
    np.testing.assert_allclose(port["loss"], float(ref["loss"]), rtol=1e-5,
                               atol=0)
    assert sorted(port["grads"]) == sorted(want)
    for k, g in want.items():
        np.testing.assert_allclose(port["grads"][k], g, **GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["mla", "ring"])
def test_mla_ring_train_step_metrics_match_reference(mla_ring_both, kind):
    ref, _, port = mla_ring_both[kind]
    np.testing.assert_allclose(port["step"]["loss"], float(ref["step_loss"]),
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(port["step"]["grad_norm"],
                               float(ref["step_grad_norm"]), rtol=1e-4,
                               atol=0)
