"""A checkpoint of a tensor-parallel jamba tree: reduced jamba's params
and AdamW state ``tp_place``d on (data 1, model 4), where each rank holds
``in_proj``'s x and z columns of its ``d_inner`` channels (a strided
shard, ``sharding.MeshSharding.split``), saved from the four gloo ranks
(a collective save: the mesh's first rank writes), then restored with
``restore(shardings=)`` onto (data 1, model 2) and onto one rank (plain
tensors). Every restored leaf, gathered whole, equals the saved tree's
bit for bit, and each mesh's ``in_proj`` shard is the paired cut of the
whole kernel, as DTensor itself lays the strided shard out."""
import numpy as np
import pytest
import torch

import torch_recurrent_tp_workers as W
from repro_torch.distributed.group import run_local

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec_ckpt")
    return run_local(W.checkpoint_ranks, 4, backend="gloo", device="cpu",
                     args=(str(d / "ckpt"),), timeout=600,
                     store_dir=str(d))


@pytest.mark.parametrize("tp", (4, 2))
def test_in_proj_shards_are_the_paired_cut(ranks, tp):
    whole = ranks[0]["saved"]["/".join(W.IN_PROJ)]
    di = whole.shape[1] // 2
    per = di // tp
    holders = ranks if tp == 4 else ranks[:2]
    for k, r in enumerate(holders):
        cols = np.r_[k * per:(k + 1) * per, di + k * per:di + (k + 1) * per]
        assert np.array_equal(r[f"local{tp}"], whole[:, cols])
    assert "_StridedShard" in ranks[0]["placements4"]
    assert "local2" not in ranks[2] and "local2" not in ranks[3]


def test_dtensor_gathers_the_paired_cut_whole(ranks):
    """DTensor's own ``full_tensor`` of the placed ``in_proj`` (torch's
    layout of a strided shard) is the whole kernel on every rank: the
    port's ``shard_index`` cuts it as torch does."""
    whole = ranks[0]["saved"]["/".join(W.IN_PROJ)]
    for r in ranks:
        assert np.array_equal(r["dtensor_gather"], whole)


@pytest.mark.parametrize("where", ["model2", "one_rank"])
def test_restored_leaves_bit_equal(ranks, where):
    want = ranks[0]["saved"]
    for r in ranks[:2] if where == "model2" else ranks[:1]:
        got = r[where]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_restored_moments_in_the_params_shapes(ranks):
    want = ranks[0]["saved"]
    for r in ranks[:2]:
        m = r["model2_opt_m"]
        assert sorted(m) == sorted(want)
        for k, v in want.items():
            assert m[k].shape == v.shape and not m[k].any(), k
