"""A checkpoint of an expert-placed tree: reduced moonshot's params and
AdamW state ``tp_place``d on (data 1, model 4), where each rank holds one
expert of four in every bank, saved from the four gloo ranks (a
collective save: the mesh's first rank writes), then restored with
``restore(shardings=)`` onto (data 1, model 2) (two experts a rank) and
onto one rank (plain tensors). Every restored leaf, gathered whole, equals
the saved tree's bit for bit. The same for 6 experts under the
'expert_ff' fallback on 'model' 4 (every expert's quarter of its FFN
columns a rank), restored onto 'model' 2 (three whole experts a rank) and
onto one rank."""
import numpy as np
import pytest
import torch

import torch_ep_workers as W
from repro_torch.distributed.group import run_local

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep_ckpt")
    path = str(d / "params.pt")
    _, _, params = W.reference_params(W.TRAIN_OVER, None, path)
    ff_path = str(d / "ff_params.pt")
    ff = W.port_params(W.TRAIN_OVER, W.FF_EXPERTS, ff_path)
    ranks = run_local(W.checkpoint_ranks, 4, backend="gloo", device="cpu",
                      args=(path, str(d / "ckpt"), ff_path), timeout=600,
                      store_dir=str(d))
    return W._np(params), ranks, W._np(ff)


def test_expert_shards_on_each_mesh(setup):
    _, ranks, _ = setup
    e = W.config(W.TRAIN_OVER).moe.n_experts
    for r in ranks:
        assert r["local4"][0] == e // 4
    for r in ranks[:2]:
        assert r["local2"][0] == e // 2
    assert "local2" not in ranks[2] and "local2" not in ranks[3]


@pytest.mark.parametrize("where", ["model2", "one_rank"])
def test_restored_leaves_bit_equal(setup, where):
    want, ranks, _ = setup
    holders = ranks[:2] if where == "model2" else ranks[:1]
    for r in holders:
        got = r[where]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_restored_moments_bit_equal(setup):
    """The AdamW moments (zeros at init) restore onto 'model' 2 in the
    params' shapes."""
    want, ranks, _ = setup
    for r in ranks[:2]:
        m = r["model2_opt_m"]
        assert sorted(m) == sorted(want)
        for k, v in want.items():
            assert m[k].shape == v.shape and not m[k].any(), k


def test_expert_ff_shards_on_each_mesh(setup):
    """6 experts: every expert's quarter of ``wg``'s and ``wdown``'s FFN
    columns a rank on 'model' 4, three whole experts a rank on 2."""
    _, ranks, _ = setup
    cfg = W.config(W.TRAIN_OVER)
    e, d, f = W.FF_EXPERTS, cfg.d_model, cfg.d_ff
    for r in ranks:
        assert r["ff_local4"] == (e, d, f // 4)
        assert r["ff_local4_down"] == (e, f // 4, d)
    for r in ranks[:2]:
        assert r["ff_local2"] == (e // 2, d, f)
        assert r["ff_local2_down"] == (e // 2, f, d)


@pytest.mark.parametrize("where", ["model2", "one_rank"])
def test_expert_ff_restored_leaves_bit_equal(setup, where):
    _, ranks, want = setup
    holders = ranks[:2] if where == "model2" else ranks[:1]
    for r in holders:
        got = r["ff_" + where]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
