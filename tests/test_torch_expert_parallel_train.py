"""The expert-parallel train step (``make_train_step(mesh=)`` with an MoE
model and a 'model' axis above 1) against the plain one-rank step.

Four gloo rank processes (one ``distributed.group.run_local``) train
reduced moonshot (4 experts, top-2, vocabulary 64, ``capacity_factor``
1.0 so capacity binds) from ``tp_place``'s DTensor tree, its weights the
reference's ``init`` through ``convert.from_jax_params``: on (data 2,
model 2), the same with ``microbatches=2``, and on (data 1, model 4),
three steps each. Losses and grad norms within 1e-4 relative of the
one-rank step on the global batch, the averaged gradients of the first
batch (``step.averaged_grads``, gathered) within ``GRAD_TOL`` (the router's
whole on every rank, not partial, not counted once per 'model' rank), and
each rank's parameter shards within ``STEP_TOL`` of the one-rank
parameters' slices (``tests/test_torch_tensor_parallel_train.py``'s
tolerances and AdamW ``eps``). The pod-compressed step on (pod 2, data 1,
model 2) reports each pod's batch routed alone, its loss and ``moe_aux``
averaged over the pods, and keeps the logical error-feedback shapes.
The 'expert_ff' fallback trains on the port's ``init`` with 6 experts on
(data 1, model 4) and with 3 on (data 2, model 2), routed over both data
ranks, within the same tolerances, each bank's shard every expert's part
of its FFN columns."""
import numpy as np
import pytest
import torch

import torch_ep_workers as W
from repro_torch.distributed.group import run_local

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol_rms=1e-5)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_train")
    path = str(d / "params.pt")
    _, _, params = W.reference_params(W.TRAIN_OVER, W.BINDING_CF, path)
    ff_paths = {e: str(d / f"ff{e}_params.pt") for e in W.FF_TRAIN_EXPERTS}
    ff = {e: W.port_params(W.TRAIN_OVER, e, p, W.BINDING_CF)
          for e, p in ff_paths.items()}
    ranks = run_local(W.train_ranks, 4, backend="gloo", device="cpu",
                      args=(path, ff_paths), timeout=600, store_dir=str(d))
    return params, ranks, ff


@pytest.fixture(scope="module")
def one_rank(setup):
    params, _, ff = setup
    return {(mb, e): W.one_rank_train(params if e is None else ff[e], mb,
                                      experts=e)
            for _, _, mb, e in W.TRAIN_CASES.values()}


@pytest.mark.parametrize("name", list(W.TRAIN_CASES))
def test_train_step_matches_one_rank(setup, one_rank, name):
    mb, experts = W.TRAIN_CASES[name][2:]
    losses, norms, params, grads = one_rank[(mb, experts)]
    for r in setup[1]:
        tl, tn, shards, tg = r["cases"][name]
        np.testing.assert_allclose(tl, losses, rtol=1e-4, atol=0)
        np.testing.assert_allclose(tn, norms, rtol=1e-4, atol=0)
        assert sorted(tg) == sorted(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(tg[k], g, **GRAD_TOL,
                                       err_msg=f"rank {r['rank']} {k}")
        assert sorted(shards) == sorted(params)
        for k, (local, sl) in shards.items():
            want = params[k][tuple(slice(a, b) for a, b in sl)]
            rms = float(np.sqrt(np.mean(params[k].astype(np.float64) ** 2)))
            np.testing.assert_allclose(
                local, want, rtol=STEP_TOL["rtol"],
                atol=STEP_TOL["atol_rms"] * rms,
                err_msg=f"rank {r['rank']} {k}")


def test_shards_are_the_ranks_experts(setup):
    """On (data 1, model 4) each bank's shard is one expert of four, the
    router and the norm gains whole, the tied embedding a quarter of the
    vocabulary."""
    cfg = W.config(W.TRAIN_OVER)
    d, f = cfg.d_model, cfg.d_ff
    blk = "stack/list/0/b0/"
    for r in setup[1]:
        shards = r["cases"]["data1_model4"][2]
        k = r["rank"]
        assert shards[blk + "moe/wi/w"][1] == ((k, k + 1), (0, d), (0, f))
        assert shards[blk + "moe/wdown/w"][1] == ((k, k + 1), (0, f),
                                                  (0, d))
        assert shards[blk + "moe/router/w"][1] == ((0, d), (0, 4))
        assert shards[blk + "ln2/gain"][1] == ((0, d),)
        assert shards["embedding/embedding"][1] == ((16 * k, 16 * k + 16),
                                                    (0, d))


def test_expert_ff_shards_are_every_experts_columns(setup):
    """On (data 1, model 4) with 6 experts each bank's shard is every
    expert's quarter of the FFN columns (``wi`` / ``wg`` on their last
    dim, ``wdown`` on its rows), the router whole."""
    cfg = W.config(W.TRAIN_OVER)
    d, f, e = cfg.d_model, cfg.d_ff, W.FF_EXPERTS
    q = f // 4
    blk = "stack/list/0/b0/"
    for r in setup[1]:
        shards = r["cases"]["ff_data1_model4"][2]
        k = r["rank"]
        assert shards[blk + "moe/wi/w"][1] == ((0, e), (0, d),
                                               (k * q, k * q + q))
        assert shards[blk + "moe/wdown/w"][1] == ((0, e), (k * q, k * q + q),
                                                  (0, d))
        assert shards[blk + "moe/router/w"][1] == ((0, d), (0, e))


def test_pod_compressed_routes_each_pod(setup):
    loss, aux = W.pod_metrics(setup[0])
    for r in setup[1]:
        np.testing.assert_allclose(r["pod"]["loss"], loss, rtol=1e-5, atol=0)
        np.testing.assert_allclose(r["pod"]["moe_aux"], aux, rtol=1e-5,
                                   atol=0)
        assert r["pod"]["err_shapes_kept"]
