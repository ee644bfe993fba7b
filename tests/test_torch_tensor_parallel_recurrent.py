"""mamba and rwkv under tensor-parallel execution over 'model'
(``distributed.sharding.activate_mesh`` + ``tp_local``) against the
one-rank forward and step on the same weights, which
``tests/test_torch_{mamba,rwkv,recurrent_models}.py`` hold to the
reference.

Reduced jamba (``torch_recurrent_tp_workers.JAMBA_TINY``: mamba with the
chunked scan, attention, and MoE expert-parallel over 'model') and
reduced rwkv (``RWKV_TINY``: the chunkwise WKV). Four gloo rank processes
run fp, SQuant w8 (quantized over the ranks' row slabs) and int4 with one
scale per 128-group (at 'model' 2; at 4 a shard splits a group, and
``tp_local`` refuses it) on (data 2, model 2) and (data 1, model 4): a
32-token prefill and decode steps, chunks of 16, 8 and 8 tokens and decode
steps after them. Each rank's logits match the one-rank forward within
``rtol=atol=1e-5`` and every routing picks the one-rank forward's experts.
Each rank holds its ``d_inner`` channels of mamba (``in_proj``'s x and z
columns of the same channels, ``x_proj`` row-parallel) and its rwkv
heads, on a state of the same; one collective a mamba forward chunk
(``x_proj``'s sum: none between ``in_proj`` and the conv). The
tensor-parallel train step on (data 2, model 2), jamba's MoE routed over
both 'data' ranks at capacity factor 1.0, and on (data 1, model 4)
matches the one-rank step (losses, grad norms, gradients at ``GRAD_TOL``,
shards at ``STEP_TOL``), and jamba's pod-compressed step on (pod 2, data
1, model 2), where ``in_proj``'s gradient is gathered across its strided
shards, tracks the plain pod step. The same step FSDP-placed over 'data'
(``fsdp_place``: ``x_proj``'s 'data' shard on its output dim, 'model'
cutting its input) on (data 2, model 2) matches the one-rank step
alike."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_recurrent_tp_workers as W
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
KEYS = [(tp, kind, name) for tp in TPS for kind in W.KINDS
        for name in W.names_at(tp)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each 'model' size's four ranks' results (one ``run_local`` each;
    the train cases in the first)."""
    return {tp: run_local(W.ranks_of, 4, backend="gloo", device="cpu",
                          args=(tp, W.names_at(tp), tp == TPS[0]),
                          timeout=600,
                          store_dir=str(tmp_path_factory.mktemp("rec")))
            for tp in TPS}


@pytest.fixture(scope="module")
def one_rank():
    return {f"{k}_{n}": W.one_rank(k, n) for k in W.KINDS for n in W.CASES}


@pytest.mark.parametrize("tp,kind,name", KEYS)
def test_forward_matches_one_rank(ranks, one_rank, tp, kind, name):
    want, _ = one_rank[f"{kind}_{name}"]
    for r in ranks[tp]:
        got = r["logits"][f"{kind}_{name}"]
        assert list(got) == list(want)
        for mode, v in want.items():
            np.testing.assert_allclose(got[mode], v, **TOL,
                                       err_msg=f"rank {r['rank']} {mode}")


@pytest.mark.parametrize("tp,name", [(tp, n) for tp in TPS
                                     for n in W.names_at(tp)])
def test_expert_picks_match_one_rank(ranks, one_rank, tp, name):
    """jamba's two MoE layers, every forward (9 a suite): each routing
    picks the one-rank forward's experts for every token, on every rank."""
    _, want = one_rank[f"jamba_{name}"]
    assert len(want) == 2 * 9
    for r in ranks[tp]:
        got = r["routes"][f"jamba_{name}"]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (r["rank"], i)


@pytest.mark.parametrize("tp", TPS)
def test_model_ranks_and_data_replicas_agree(ranks, tp):
    r0 = ranks[tp][0]["logits"]
    for r in ranks[tp][1:]:
        for key, modes in r0.items():
            for mode, v in modes.items():
                assert np.array_equal(r["logits"][key][mode], v), \
                    (r["rank"], key, mode)


@pytest.mark.parametrize("tp", TPS)
def test_local_shards_states_and_collectives(ranks, tp):
    """Every rank's mixer leaves: mamba's ``in_proj`` (d_model, 2·d_inner
    / tp), ``conv_w`` / ``dt_proj`` / ``out_proj`` on its channels,
    ``x_proj`` row-parallel (d_inner / tp, dt_rank + 2·d_state), the
    vectors whole; rwkv's time-mix products on its heads, the decay LoRA
    and ``u`` whole; each state of the local channels and heads, the
    token-shift rows whole. A mamba forward chunk runs one collective
    (``x_proj``'s sum), a decode step of each model a fixed count; past
    'model' 2 the int4 128-group cut is refused."""
    jc, rc = W.config("jamba"), W.config("rwkv")
    di, d = 2 * jc.d_model, jc.d_model
    r_, n = jc.mamba.dt_rank or d // 16, jc.mamba.d_state
    jamba = {"in_proj/w": (d, 2 * di // tp), "conv_w": (4, di // tp),
             "conv_b": (di,), "x_proj/w": (di // tp, r_ + 2 * n),
             "dt_proj/w": (r_, di // tp), "dt_bias": (di,),
             "a_log": (di, n), "d_skip": (di,),
             "out_proj/w": (di // tp, d)}
    rd, hd = rc.d_model, rc.rwkv_head_dim
    heads = rd // hd
    rwkv = {f"tm/{k}/w": (rd, rd // tp) for k in ("wr", "wk", "wv", "wg")}
    rwkv.update({"tm/wo/w": (rd // tp, rd), "tm/w_lora_a/w": (rd, 64),
                 "tm/w_lora_b/w": (64, rd), "tm/u": (heads, hd),
                 "tm/w0": (rd,), "tm/ln_x/gain": (rd,),
                 "cm/wk/w": (rd, rc.d_ff // tp), "cm/wv/w": (rc.d_ff // tp,
                                                            rd),
                 "cm/wr/w": (rd, rd // tp), "ln1/gain": (rd,),
                 "ln2/gain": (rd,)})
    rwkv.update({f"tm/mu/{s}": (rd,) for s in "rkvgd"})
    rwkv.update({f"cm/mu/{s}": (rd,) for s in "kr"})
    for r in ranks[tp]:
        assert r["shapes"]["jamba"] == jamba
        assert r["shapes"]["rwkv"] == rwkv
        assert r["cache"]["jamba"] == {"h": (2, di // tp, n),
                                       "conv": (2, 3, di // tp)}
        assert r["cache"]["rwkv"] == {"x_tm": (2, rd), "x_cm": (2, rd),
                                      "wkv": (2, heads // tp, hd, hd)}
        assert r["mamba_collectives"] == {"chunk8": 1, "prefill32": 4}
        assert r["jamba_decode_collectives"] == 13
        assert r["rwkv_decode_collectives"] == 10
        if tp > W.W4G_MAX_TP:
            for kind in W.KINDS:
                assert "splits a group of 128" in r["raised"][kind]


@pytest.mark.parametrize("tp", TPS)
def test_in_proj_holds_the_same_x_and_z_channels(ranks, tp):
    """The w8 ``in_proj`` codes and scale rows each rank holds are rows
    ``[k·d_inner/tp, (k+1)·d_inner/tp)`` of x and the same rows of z of
    the whole tree's (``quantize_tree`` on one rank: the slab-quantized
    tree is bit-equal to it), bit for bit."""
    _, whole = W.case("jamba", "w8")
    qt = W.TPW._at(whole, W.IN_PROJ)
    di = qt.shape[0] // 2
    per = di // tp
    for r in ranks[tp]:
        k = r["coord"][1]
        rows = np.r_[k * per:(k + 1) * per, di + k * per:di + (k + 1) * per]
        codes, scale = r["in_proj_w8"]
        np.testing.assert_array_equal(codes, qt.data.numpy()[rows])
        np.testing.assert_array_equal(scale, qt.scale.numpy()[rows])


@pytest.fixture(scope="module")
def one_rank_train():
    return {k: W.one_rank_train(k) for k in W.KINDS}


@pytest.mark.parametrize("kind,name", [(k, n) for k in W.KINDS
                                       for n in W.TRAIN_CASES])
def test_train_step_matches_one_rank(ranks, one_rank_train, kind, name):
    losses, norms, params, grads = one_rank_train[kind]
    for r in ranks[TPS[0]]:
        tl, tn, shards, tg = r["train"]["cases"][f"{kind}_{name}"]
        np.testing.assert_allclose(tl, losses, rtol=1e-4, atol=0)
        np.testing.assert_allclose(tn, norms, rtol=1e-4, atol=0)
        assert sorted(tg) == sorted(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(tg[k], g, **GRAD_TOL,
                                       err_msg=f"rank {r['rank']} {k}")
        assert sorted(shards) == sorted(params)
        for k, (local, idx) in shards.items():
            want = params[k]
            for dim, ix in enumerate(idx):
                want = np.take(want, np.arange(*ix) if isinstance(ix, tuple)
                               else ix, axis=dim)
            rms = float(np.sqrt(np.mean(params[k].astype(np.float64) ** 2)))
            np.testing.assert_allclose(
                local, want, rtol=STEP_TOL["rtol"],
                atol=STEP_TOL["atol_rms"] * rms,
                err_msg=f"rank {r['rank']} {k}")


def test_pod_compressed_on_model_tracks_the_plain_pod_step(ranks):
    """jamba on (pod 2, data 1, model 2) against (pod 2, data 1): the same
    losses within 1e-4 relative, the error-feedback buffers in their
    logical shapes."""
    train = [r["train"] for r in ranks[TPS[0]]]
    plain = train[0]["pod_plain"]
    assert plain["shapes_kept"]
    for t in train:
        assert t["pod_tp"]["shapes_kept"]
        np.testing.assert_allclose(t["pod_tp"]["losses"], plain["losses"],
                                   rtol=1e-4, atol=0)


@pytest.mark.parametrize("tp", (2, 4, 8))
def test_check_tensor_parallel_takes_mamba_and_rwkv(tp):
    """jamba-1.5-large and rwkv6-1.6b at full width run tensor-parallel at
    'model' 2, 4 and 8, and ``make_train_step`` takes them (past the check
    it wants a ``DeviceMesh`` of live ranks)."""
    mesh = AbstractMesh((1, tp), ("data", "model"))
    for arch in ("jamba-1.5-large-398b", "rwkv6-1.6b"):
        cfg = get_config(arch)
        check_tensor_parallel(cfg, mesh)
        with pytest.raises(ValueError, match="runs on a DeviceMesh"):
            tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                                  mesh=mesh)
    small = dataclasses.replace(W.config("rwkv"), d_model=96)
    with pytest.raises(NotImplementedError,
                       match="not ported yet: rwkv's 3 heads"):
        check_tensor_parallel(small, mesh)
