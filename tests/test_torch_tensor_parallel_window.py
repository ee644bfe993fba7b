"""The sliding-window ring under tensor-parallel execution over 'model',
with expert parallelism inside its blocks, against the one-rank forward
and step on the same weights, which ``tests/test_torch_window.py`` and
``tests/test_torch_mla_window_models.py`` hold to the reference.

Reduced mixtral (4 experts, top-2, a 32-token window) with 8 q and 4 KV
heads (``torch_mla_ring_workers.RING_TINY``; the reduced config's one KV
head divides no 'model' axis) on a 64-position cache: a ring of 32 slots
of each rank's KV heads. Four gloo rank processes run fp and SQuant w8
trees on (data 2, model 2) and (data 1, model 4): a 40-token prefill past
the ring and decode steps after it, a 29-token prefill and decode steps
across the ring's end, and chunks of 20, 20 (wrapping the ring) and 8
tokens. Each rank's logits match the one-rank forward within
``rtol=atol=1e-5`` and every routing picks its experts. The train step
on (data 2, model 2), its MoE layers routed over both 'data' ranks at
capacity factor 1.0 (capacity binds), and on (data 1, model 4), over
48-token sequences past the window, matches the one-rank step (losses,
grad norms, gradients at ``GRAD_TOL``, shards at ``STEP_TOL``)."""

import numpy as np
import pytest
import torch

import torch_mla_ring_workers as W
from repro_torch.configs import get_config
from repro_torch.distributed.group import run_local
from repro_torch.distributed.sharding import (AbstractMesh,
                                              check_tensor_parallel)
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol_rms=1e-5)
TPS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each 'model' size's four ranks' results (one ``run_local`` each;
    the train cases in the first)."""
    return {tp: run_local(W.ranks_of, 4, backend="gloo", device="cpu",
                          args=(tp, [], list(W.RING_CASES),
                                ["ring"] if tp == TPS[0] else []),
                          timeout=600,
                          store_dir=str(tmp_path_factory.mktemp("ring")))
            for tp in TPS}


@pytest.fixture(scope="module")
def one_rank():
    return {n: W.ring_forward_one_rank(n) for n in W.RING_CASES}


@pytest.mark.parametrize("tp,name", [(tp, n) for tp in TPS
                                     for n in W.RING_CASES])
def test_forward_matches_one_rank(ranks, one_rank, tp, name):
    want, _ = one_rank[name]
    for r in ranks[tp]:
        got = r["ring"][name]
        assert list(got) == list(want)
        for mode, v in want.items():
            np.testing.assert_allclose(got[mode], v, **TOL,
                                       err_msg=f"rank {r['rank']} {mode}")


@pytest.mark.parametrize("tp,name", [(tp, n) for tp in TPS
                                     for n in W.RING_CASES])
def test_expert_picks_match_one_rank(ranks, one_rank, tp, name):
    """Every routing of every forward (2 MoE layers x 13 forwards) picks
    the one-rank forward's experts for every token, on every rank."""
    _, want = one_rank[name]
    assert len(want) == 2 * 13
    for r in ranks[tp]:
        got = r["routes"][name]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (r["rank"], i)


@pytest.mark.parametrize("tp", TPS)
def test_ring_holds_the_ranks_kv_heads(ranks, tp):
    """The ring has the window's 32 slots of this rank's KV heads."""
    for r in ranks[tp]:
        assert r["ring_cache"] == (2, W.RING_TINY["window"],
                                   W.RING_TINY["n_kv_heads"] // tp, 16)


@pytest.fixture(scope="module")
def one_rank_train():
    return W.one_rank_train("ring")


@pytest.mark.parametrize("name", list(W.TRAIN_CASES))
def test_train_step_matches_one_rank(ranks, one_rank_train, name):
    losses, norms, params, grads = one_rank_train
    for r in ranks[TPS[0]]:
        tl, tn, shards, tg = r["train"]["cases"][f"ring_{name}"]
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


@pytest.mark.parametrize("tp", (2, 4, 16))
def test_check_tensor_parallel_takes_the_ring(tp):
    """mixtral at full width (8 experts, 32 q / 8 KV heads, window 4096)
    runs tensor-parallel at 'model' 2, 4 and the production mesh's 16, and
    ``make_train_step`` (plain and pod-compressed) takes it: at 16 its 8
    experts take the 'expert_ff' fallback and its 8 KV heads lie on
    replica groups (two ranks a KV head)."""
    cfg = get_config("mixtral-8x7b")
    mesh = AbstractMesh((1, tp), ("data", "model"))
    check_tensor_parallel(cfg, mesh)
    # past the check: the step then wants a DeviceMesh of live ranks
    with pytest.raises(ValueError, match="runs on a DeviceMesh"):
        tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                              mesh=mesh)
    with pytest.raises(ValueError, match="runs on a DeviceMesh"):
        tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                              pod_compress=True, mesh=AbstractMesh(
                                  (2, 1, tp), ("pod", "data", "model")))
