"""MLA under tensor-parallel execution over 'model' (``distributed.
sharding.activate_mesh`` + ``tp_local``) against the one-rank forward and
step on the same weights, which ``tests/test_torch_mla.py`` holds to the
reference.

minicpm3 at test widths (``torch_mla_ring_workers.MLA_TINY``: 8 heads,
latent ranks 128). Four gloo rank processes run every case of
``MLA_CASES`` on (data 2, model 2) and on (data 1, model 4): fp weights,
SQuant w8 quantized over the ranks' row slabs, int4 with one scale per
128-group (at 'model' 2; at 4 a shard of ``wo``'s 256 input columns would
split a group, and ``tp_local`` refuses it), the absorbed decode
(``MLAConfig.absorb``) and bfloat16. Each rank's prefill, chunked-prefill
and decode logits match the one-rank forward within ``rtol=atol=1e-5`` in
float32 and ``2e-2`` in bfloat16. Each rank holds its heads' columns of
``q_up`` / ``kv_up`` and rows of ``wo``, its latent columns of ``q_down``
/ ``kv_down``, the norm gains and the compressed cache whole. The
tensor-parallel train step on (data 2, model 2) and (data 1, model 4)
matches the one-rank step (losses, grad norms, gradients at ``GRAD_TOL``,
shards at ``STEP_TOL``), and the pod-compressed step on (pod 2, data 1,
model 2) tracks the plain pod step."""
import dataclasses

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
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol_rms=1e-5)
TPS = (2, 4)


def _names(tp):
    return [n for n, (_, q) in W.MLA_CASES.items()
            if not (q and q[2:] and tp > W.W4G_MAX_TP)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each 'model' size's four ranks' results (one ``run_local`` each;
    the train cases in the first)."""
    return {tp: run_local(W.ranks_of, 4, backend="gloo", device="cpu",
                          args=(tp, _names(tp), [],
                                ["mla"] if tp == TPS[0] else []),
                          timeout=600,
                          store_dir=str(tmp_path_factory.mktemp("mla")))
            for tp in TPS}


@pytest.fixture(scope="module")
def one_rank():
    return {n: W.mla_forward_one_rank(n) for n in W.MLA_CASES}


@pytest.mark.parametrize("tp,name", [(tp, n) for tp in TPS
                                     for n in _names(tp)])
def test_forward_matches_one_rank(ranks, one_rank, tp, name):
    over = W.MLA_CASES[name][0]
    tol = TOL[over.get("dtype", W.MLA_TINY["dtype"])]
    want = one_rank[name]
    for r in ranks[tp]:
        got = r["mla"][name]
        assert list(got) == list(want)
        for mode, v in want.items():
            np.testing.assert_allclose(got[mode], v, **tol,
                                       err_msg=f"rank {r['rank']} {mode}")


@pytest.mark.parametrize("tp", TPS)
def test_model_ranks_and_data_replicas_agree(ranks, tp):
    r0 = ranks[tp][0]["mla"]
    for r in ranks[tp][1:]:
        for name, modes in r0.items():
            for mode, v in modes.items():
                assert np.array_equal(r["mla"][name][mode], v), \
                    (r["rank"], name, mode)


@pytest.mark.parametrize("tp", TPS)
def test_shards_and_the_whole_compressed_cache(ranks, tp):
    """Every rank's attention leaves: the latent down-projections cut on
    their outputs, the up-projections on their heads' columns, ``wo`` on
    its heads' rows, the norm gains whole; the compressed cache whole on
    every rank; at 'model' 4 the int4 128-group cut is refused."""
    d, h, m = W.MLA_TINY["d_model"], W.MLA_TINY["n_heads"], W.MLA_DIMS
    qk, kvo = m["nope_dim"] + m["rope_dim"], m["nope_dim"] + m["v_dim"]
    want = {"q_down/w": (d, m["q_lora"] // tp),
            "q_norm/gain": (m["q_lora"],),
            "q_up/w": (m["q_lora"], h * qk // tp),
            "kv_down/w": (d, (m["kv_lora"] + m["rope_dim"]) // tp),
            "kv_norm/gain": (m["kv_lora"],),
            "kv_up/w": (m["kv_lora"], h * kvo // tp),
            "wo/w": (h * m["v_dim"] // tp, d)}
    for r in ranks[tp]:
        assert r["mla_shapes"] == want
        assert r["mla_cache"] == {"c_kv": (2, 8, m["kv_lora"]),
                                  "k_rope": (2, 8, 1, m["rope_dim"])}
        if tp > W.W4G_MAX_TP:
            assert "splits a group of 128" in r["w4g_split_group"]


@pytest.fixture(scope="module")
def one_rank_train():
    return W.one_rank_train("mla")


@pytest.mark.parametrize("name", list(W.TRAIN_CASES))
def test_train_step_matches_one_rank(ranks, one_rank_train, name):
    losses, norms, params, grads = one_rank_train
    for r in ranks[TPS[0]]:
        tl, tn, shards, tg = r["train"]["cases"][f"mla_{name}"]
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


def test_pod_compressed_on_model_tracks_the_plain_pod_step(ranks):
    """(pod 2, data 1, model 2) against (pod 2, data 1): the same losses
    within 1e-4 relative, the error-feedback buffers in their logical
    shapes."""
    train = [r["train"] for r in ranks[TPS[0]]]
    plain = train[0]["pod_plain"]
    assert plain["shapes_kept"]
    for t in train:
        assert t["pod_tp"]["shapes_kept"]
        np.testing.assert_allclose(t["pod_tp"]["losses"], plain["losses"],
                                   rtol=1e-4, atol=0)


@pytest.mark.parametrize("tp", (2, 4, 8))
def test_check_tensor_parallel_takes_mla(tp):
    """minicpm3 at full width (768 and 288 latent ranks, 40 heads) runs
    tensor-parallel at 'model' 2, 4 and 8, and ``make_train_step`` takes
    it; reduced minicpm3's ``kv_down`` (12 outputs) on a 'model' axis of
    8 raises its named ``NotImplementedError``."""
    cfg = get_config("minicpm3-4b")
    mesh = AbstractMesh((1, tp), ("data", "model"))
    check_tensor_parallel(cfg, mesh)
    # past the check: the step then wants a DeviceMesh of live ranks
    with pytest.raises(ValueError, match="runs on a DeviceMesh"):
        tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                              mesh=mesh)
    small = dataclasses.replace(get_config("minicpm3-4b", reduced=True),
                                n_heads=8, n_kv_heads=8)
    if tp < 8:
        check_tensor_parallel(small, mesh)
    else:
        with pytest.raises(NotImplementedError,
                           match="not ported yet: MLA latent ranks on a "
                                 "'model' axis of 8"):
            check_tensor_parallel(small, mesh)
