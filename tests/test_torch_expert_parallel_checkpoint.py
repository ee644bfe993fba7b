"""A checkpoint of an expert-placed tree: reduced moonshot's params and
AdamW state ``tp_place``d on (data 1, model 4), where each rank holds one
expert of four in every bank, saved from the four gloo ranks (a
collective save: the mesh's first rank writes), then restored with
``restore(shardings=)`` onto (data 1, model 2) (two experts a rank) and
onto one rank (plain tensors). Every restored leaf, gathered whole, equals
the saved tree's bit for bit."""
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
    ranks = run_local(W.checkpoint_ranks, 4, backend="gloo", device="cpu",
                      args=(path, str(d / "ckpt")), timeout=600,
                      store_dir=str(d))
    return W._np(params), ranks


def test_expert_shards_on_each_mesh(setup):
    _, ranks = setup
    e = W.config(W.TRAIN_OVER).moe.n_experts
    for r in ranks:
        assert r["local4"][0] == e // 4
    for r in ranks[:2]:
        assert r["local2"][0] == e // 2
    assert "local2" not in ranks[2] and "local2" not in ranks[3]


@pytest.mark.parametrize("where", ["model2", "one_rank"])
def test_restored_leaves_bit_equal(setup, where):
    want, ranks = setup
    holders = ranks[:2] if where == "model2" else ranks[:1]
    for r in holders:
        got = r[where]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_restored_moments_bit_equal(setup):
    """The AdamW moments (zeros at init) restore onto 'model' 2 in the
    params' shapes."""
    want, ranks = setup
    for r in ranks[:2]:
        m = r["model2_opt_m"]
        assert sorted(m) == sorted(want)
        for k, v in want.items():
            assert m[k].shape == v.shape and not m[k].any(), k
