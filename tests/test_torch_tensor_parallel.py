"""Tensor-parallel forward (``distributed.sharding.activate_mesh`` +
``tp_local``) against the one-rank forward on the same weights, which
``tests/test_torch_model.py`` holds to the reference.

Four gloo rank processes (``distributed.group.run_local``) run every case
of ``torch_tp_workers.FORWARD_CASES`` once on a (data 2, model 2) mesh and
once on (data 1, model 4): fp, w8 per-channel and w4 SQuant trees (also
in the checkpointable ``w_q4`` / ``w_scale`` form), int4 with one scale
per 128-group (at 'model' 2), tied and untied heads, a vocabulary
'model' divides (vocab-parallel embedding and head) and one it does not
(257, replicated like granite's 49 155), qk-norm with a GeGLU FFN, and
bfloat16; at 'model' 4 also the replica-group cases
(``torch_tp_workers.GROUP_CASES``: 8 q / 2 KV heads, 6 q / 2 KV, MLA with
6 heads, ``d_ff`` 130), whose heads or FFN columns 4 does not divide;
and at both sizes the encoder-decoder (``torch_tp_workers.ENCDEC_CASES``:
reduced seamless over random frames, fp and w8, its vocabulary
vocab-parallel at 2 and replicated at 4), whose encoder output and cache
``enc_out`` are whole on every rank.
Each
rank's prefill, chunked-prefill and decode logits match the one-rank
forward within ``rtol=atol=1e-5`` in float32 and ``2e-2`` in bfloat16; the
TP-local codes and scales are bit-equal slices of the whole tree, the
per-group scales of a row-parallel leaf cut at its groups."""
import math

import numpy as np
import pytest
import torch

import torch_tp_workers as W
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.group import run_local
from repro_torch.distributed.sharding import (AbstractMesh,
                                              check_tensor_parallel)
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TPS = (2, 4)


def _names(tp):
    return [n for n, (_, q) in W.FORWARD_CASES.items()
            if not (q and q[2:] and tp > W.W4G_MAX_TP)
            and (n not in W.GROUP_CASES or tp == W.GROUP_TP)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each 'model' size's four ranks' results (one ``run_local`` each)."""
    return {tp: run_local(W.forward_ranks, 4, backend="gloo", device="cpu",
                          args=(tp, _names(tp)), timeout=600,
                          store_dir=str(tmp_path_factory.mktemp("tp")))
            for tp in TPS}


@pytest.fixture(scope="module")
def one_rank():
    return {n: W.forward_suite(*W.case_tree(n)) for n in W.FORWARD_CASES}


@pytest.mark.parametrize("tp,name", [(tp, n) for tp in TPS
                                     for n in _names(tp)])
def test_forward_matches_one_rank(ranks, one_rank, tp, name):
    over = W.FORWARD_CASES[name][0]
    tol = TOL[over.get("dtype", W.TP_TINY["dtype"])]
    want = one_rank[name]
    for r in ranks[tp]:
        got = r["logits"][name]
        assert list(got) == list(want)
        for mode, v in want.items():
            np.testing.assert_allclose(got[mode], v, **tol,
                                       err_msg=f"rank {r['rank']} {mode}")


@pytest.mark.parametrize("tp", TPS)
def test_model_ranks_and_data_replicas_agree(ranks, tp):
    """Every rank ends with the same whole logits, bit for bit: the 'model'
    ranks of a replica through the same collectives, the data replicas of
    a (2, 2) mesh on the same local shards."""
    r0 = ranks[tp][0]["logits"]
    for r in ranks[tp][1:]:
        for name, modes in r0.items():
            for mode, v in modes.items():
                assert np.array_equal(r["logits"][name][mode], v), \
                    (r["rank"], name, mode)


@pytest.mark.parametrize("tp", TPS)
def test_quantized_shards_are_slices_of_the_whole_tree(ranks, tp):
    """Codes and scales of every rank's local tree (quantized over the
    four ranks' row slabs, gathered, then cut by ``tp_local``) equal
    slices of ``quantize_tree(mesh=None)``'s bit for bit: column-parallel
    leaves by rows with their scale rows, row-parallel leaves by input
    columns (packed int4 by bytes) with a per-channel scale whole and a
    per-group one cut at this rank's groups; a leaf whose heads 'model'
    does not divide at its replica group's shard, the same on the ranks
    that share it."""
    compared = 0
    for name in _names(tp):
        if name not in ranks[tp][0]["quant"]:
            continue
        model, whole = W.case_tree(name)
        cfg = model.cfg
        for r in ranks[tp]:
            k = r["coord"][1]
            for path, (codes, scale, shape) in r["quant"][name].items():
                qt = W._at(whole, path.split("/"))
                node = path.split("/")[-2]
                row_parallel = node in ("wo", "wdown")
                # the shards: tp of them, or gcd(units, tp) on replica
                # groups of tp / gcd ranks (rank k holds shard k // r)
                units = cfg.d_ff if node in ("wi", "wg", "wdown") \
                    else cfg.n_heads
                n = math.gcd(units, tp)
                j = k // (tp // n)
                if path.startswith("lm_head") and qt.shape[0] % tp:
                    want_c, want_s = qt.data, qt.scale   # replicated head
                    assert shape == qt.shape
                elif path.startswith("lm_head"):
                    m = qt.data.shape[0] // tp
                    want_c = qt.data[k * m:(k + 1) * m]
                    want_s = qt.scale[k * m:(k + 1) * m]
                    assert shape == (qt.shape[0] // tp, qt.shape[1])
                elif row_parallel:
                    c = qt.data.shape[1] // n
                    want_c = qt.data[:, j * c:(j + 1) * c]
                    g = qt.scale.shape[1] // n if qt.scale.shape[1] > 1 \
                        else None
                    want_s = qt.scale if g is None else \
                        qt.scale[:, j * g:(j + 1) * g]
                    assert shape == (qt.shape[0], qt.shape[1] // n)
                else:
                    m = qt.data.shape[0] // n
                    want_c = qt.data[j * m:(j + 1) * m]
                    want_s = qt.scale[j * m:(j + 1) * m]
                    assert shape == (qt.shape[0] // n, qt.shape[1])
                np.testing.assert_array_equal(codes, want_c.numpy())
                np.testing.assert_array_equal(scale, want_s.numpy())
                compared += 1
    assert compared > 0


@pytest.mark.parametrize("tp", TPS)
def test_cache_and_out_of_scope_modes(ranks, tp):
    """The contiguous cache holds this rank's KV heads (an
    encoder-decoder's ``enc_out`` whole); speculative verify and the paged
    KV layout raise their named ``NotImplementedError``; at 'model' 4 an
    int4 shard of ``wo``'s 256 input columns would split a 128-group, and
    ``tp_local`` refuses it."""
    over = W.ENCDEC_OVER
    for r in ranks[tp]:
        assert r["cache_k_shape"] == (1, 4, W.TP_TINY["n_kv_heads"] // tp,
                                      W.TP_TINY["head_dim"])
        assert r["encdec_cache_shapes"] == (
            (1, 8, over["n_kv_heads"] // tp, over["head_dim"]),
            (1, 2, W.TP_TINY["d_model"]))
        # two ranks share each of the 2 KV heads at 'model' 4: one head a
        # rank, not 2 // 4 = 0
        for name, shape in r["group_cache_k_shape"].items():
            kv = dict(W.TP_TINY, **W.GROUP_CASES[name][0])["n_kv_heads"]
            assert tp == W.GROUP_TP and shape == (
                1, 4, kv // math.gcd(kv, tp), W.TP_TINY["head_dim"]), name
        for mode in ("verify", "paged_decode"):
            assert r["raised"][mode].startswith(
                "not ported yet: speculative verify and the paged KV "
                "layout")
        if tp > W.W4G_MAX_TP:
            assert "splits a group of 128" in r["raised"]["w4g_split_group"]


_OUT_OF_SCOPE = {
    # the experts 'model' does not divide take the reference's 'expert_ff'
    # fallback (every expert's FFN columns); a dividing axis is
    # expert-parallel
    "moe": ("moonshot-v1-16b-a3b", dict(moe=MoEConfig(6, 2)), (1, 4), None),
    # a mamba d_inner 'model' does not divide (2 x 65 on 4)
    "d_inner": ("jamba-1.5-large-398b", dict(moe=None, d_model=65), (1, 4),
                "mamba's d_inner 130 on a 'model' axis of 4"),
    # the encoder and the cross-attention run this rank's heads
    "encdec": ("seamless-m4t-medium", {}, (1, 2), None),
    # heads and an FFN width 'model' does not divide run on replica groups
    # (sharding.replica_groups): past the check, the step wants a
    # DeviceMesh of live ranks
    "kv_heads": ("granite-3-8b", None, (16, 16), None),
    "d_ff": ("granite-3-8b", dict(d_ff=130, n_kv_heads=4), (1, 4), None),
}


@pytest.mark.parametrize("case", list(_OUT_OF_SCOPE))
def test_out_of_scope_configs_raise(case):
    """Each case tensor-parallel execution does not take raises its named
    ``NotImplementedError`` from ``check_tensor_parallel`` and from
    ``make_train_step``; granite's 8 KV heads on the production mesh's
    'model' axis of 16 (through an ``AbstractMesh``, at full width), a
    ``d_ff`` of 130 on 4, 6 experts on 4 (the 'expert_ff' fallback) and
    the encoder-decoder pass the check, and the step raises only that it
    runs on a ``DeviceMesh``."""
    import dataclasses
    arch, over, shape, what = _OUT_OF_SCOPE[case]
    cfg = get_config(arch) if over is None else dataclasses.replace(
        get_config(arch, reduced=True), **over)
    mesh = AbstractMesh(shape, ("data", "model"))
    if what is None:
        check_tensor_parallel(cfg, mesh)
        for kw in (dict(mesh=mesh), dict(pod_compress=True, mesh=AbstractMesh(
                (2,) + shape, ("pod", "data", "model")))):
            with pytest.raises(ValueError, match="runs on a DeviceMesh"):
                tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                                      **kw)
        return
    match = "not ported yet: " + what
    with pytest.raises(NotImplementedError, match=match):
        check_tensor_parallel(cfg, mesh)
    with pytest.raises(NotImplementedError, match=match):
        tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                              mesh=mesh)
    with pytest.raises(NotImplementedError, match=match):
        tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                              pod_compress=True, mesh=AbstractMesh(
                                  (2,) + shape, ("pod", "data", "model")))
    check_tensor_parallel(cfg, AbstractMesh((2, 1), ("data", "model")))


# the production mesh's 'model' 16 (launch/mesh.make_production_mesh):
# every config of the zoo passes (mixtral's 8 experts on the 'expert_ff'
# fallback); an entry would name a config's expected error
_AT_16 = {}


@pytest.mark.parametrize("arch", ["chameleon-34b", "gemma-7b", "granite-3-8b",
                                  "jamba-1.5-large-398b", "minicpm3-4b",
                                  "minitron-4b", "mixtral-8x7b",
                                  "moonshot-v1-16b-a3b", "rwkv6-1.6b",
                                  "seamless-m4t-medium"])
def test_production_model_axis_sweep(arch):
    """``check_tensor_parallel`` at full width on ``AbstractMesh((1, 16),
    ("data", "model"))``: granite, chameleon, jamba and minitron (8 KV
    heads, minitron's 24 q heads too) and minicpm3 (40 MLA heads) pass on
    replica groups beside gemma, moonshot and rwkv, mixtral (8 experts)
    on the 'expert_ff' fallback, and seamless with its encoder; and every
    config passes at 'model' 2, 4 and 8."""
    from repro_torch.configs import list_archs
    assert arch in list_archs()
    cfg = get_config(arch)
    for tp in (2, 4, 8):
        check_tensor_parallel(cfg, AbstractMesh((1, tp), ("data", "model")))
    mesh = AbstractMesh((1, 16), ("data", "model"))
    if arch not in _AT_16:
        check_tensor_parallel(cfg, mesh)
        return
    with pytest.raises(NotImplementedError,
                       match="not ported yet: " + _AT_16[arch]):
        check_tensor_parallel(cfg, mesh)
