"""The tensor-parallel train step (``make_train_step(mesh=)`` with a
'model' axis above 1) against the plain one-rank step.

Four gloo rank processes (one ``distributed.group.run_local``) train
``torch_tp_workers``' model (vocabulary 64, so 'model' 2 and 4 shard the
embedding) from ``tp_place``'s DTensor tree: on (data 2, model 2), also
with ``clip_norm`` active (a norm that counted the replicated leaves once
per 'model' rank would clip differently), and on (data 1, model 4), three
steps each, and on (data 1, model 4) with heads and an FFN width 4 does
not divide (``torch_tp_workers.GROUP_TRAIN_OVER``: 8 q / 2 KV heads; 6
q / 2 KV with ``d_ff`` 130, on replica groups): losses and grad norms
within 1e-4 relative of the one-rank step, the averaged gradients of the
first batch within ``GRAD_TOL`` and each rank's parameter shards within
``STEP_TOL`` of the one-rank parameters' slices
(``tests/test_torch_train_step.py``'s tolerances; the AdamW ``eps`` of
these cases is explained in ``torch_tp_workers``). The
pod-compressed step on (pod 2, data 1, model 2) learns as the reference's
``tests/test_distributed.py::test_pod_compressed_training_learns``
asserts, keeps the logical error-feedback layout, and tracks the
non-tensor-parallel pod step (losses, and the first step's error-feedback
rows within one int8 quantum). A ``Trainer`` on (data 1, model 2) saves,
stops and resumes to the losses of an uninterrupted run, and a tree
sharded over 'data' (FSDP) is refused by name. The replica-group model's
checkpoint saved at 'model' 4 restores bit-equal at 2 and 1, and the
save at 2 back at 4; its pod-compressed step at 'model' 2 (one KV head,
``d_ff`` 129, whole on both ranks) tracks the plain pod step. The
encoder-decoder (reduced seamless over random frames, vocabulary 66:
vocab-parallel at 'model' 2, replicated at 4) trains on (data 2, model
2) and (data 1, model 4) within the same tolerances, and its checkpoint
saved at 'model' 4 restores bit-equal at 2 and 1 and back at 4."""
import numpy as np
import pytest
import torch

import torch_tp_workers as W
from repro_torch.distributed.group import run_local

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
STEP_TOL = dict(rtol=1e-4, atol_rms=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_train")
    return run_local(W.train_ranks, 4, backend="gloo", device="cpu",
                     args=(str(d),), timeout=600, store_dir=str(d))


@pytest.mark.parametrize("name", list(W.TRAIN_CASES))
def test_train_step_matches_one_rank(ranks, name):
    ocfg = W.TRAIN_CASES[name][2]
    losses, norms, params = W.one_rank_train(ocfg, W.TRAIN_STEPS,
                                             over=W.train_over(name))
    grads = W.one_rank_grads(over=W.train_over(name))
    if "clip" in name:
        assert min(norms) > ocfg["clip_norm"]        # the clip is active
    for r in ranks:
        tl, tn, shards, tg = r["cases"][name]
        np.testing.assert_allclose(tl, losses, rtol=1e-4, atol=0)
        np.testing.assert_allclose(tn, norms, rtol=1e-4, atol=0)
        assert sorted(tg) == sorted(grads)
        for k, g in grads.items():
            np.testing.assert_allclose(tg[k], g, **GRAD_TOL, err_msg=k)
        assert sorted(shards) == sorted(params)
        for k, (local, sl) in shards.items():
            want = params[k][tuple(slice(a, b) for a, b in sl)]
            rms = float(np.sqrt(np.mean(params[k].astype(np.float64) ** 2)))
            np.testing.assert_allclose(
                local, want, rtol=STEP_TOL["rtol"],
                atol=STEP_TOL["atol_rms"] * rms,
                err_msg=f"rank {r['rank']} {k}")


def test_model_shards_split_the_sharded_leaves(ranks):
    """On (data 1, model 4) a column-parallel kernel's shard is a quarter
    of its columns, a row-parallel kernel's a quarter of its rows, the
    vocab-parallel embedding a quarter of the vocabulary, and a norm gain
    whole on every rank."""
    shards = ranks[1]["cases"]["data1_model4"][2]
    d, f = W.TP_TINY["d_model"], W.TP_TINY["d_ff"]
    blk = "stack/list/0/b0/"
    assert shards[blk + "ffn/wi/w"][1] == ((0, d), (f // 4, f // 2))
    assert shards[blk + "ffn/wdown/w"][1] == ((f // 4, f // 2), (0, d))
    assert shards["embedding/embedding"][1] == ((16, 32), (0, d))
    assert shards[blk + "ln1/gain"][1] == ((0, d),)


@pytest.mark.parametrize("where", ["model2", "one_rank", "back4"])
def test_replica_group_checkpoint_restores_bit_equal(ranks, where):
    """Leaves cut by heads or FFN columns 'model' does not divide are held
    whole (``Replicate``) on 'model' 4 and cut plainly on 2, and the
    checkpoint holds the logical arrays: restored at 'model' 2, on one
    rank, and from the 'model' 2 save back at 4, every leaf equals the
    saved tree's bit for bit."""
    want = ranks[0]["group_ckpt"]["saved"]
    holders = {"model2": ranks[:2], "one_rank": ranks[:1],
               "back4": ranks}[where]
    for r in holders:
        got = r["group_ckpt"][where]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    # wq's 6 heads: whole on 'model' 4 (replica groups), cut in three-head
    # shards on 'model' 2
    assert "Shard" not in ranks[0]["group_ckpt"]["placements4"]
    assert "Shard(dim=1)" in ranks[0]["group_ckpt"]["placements2"]
    for r in ranks[:2]:
        m = r["group_ckpt"]["model2_opt_m"]
        assert all(not m[k].any() and m[k].shape == v.shape
                   for k, v in want.items())


@pytest.mark.parametrize("where", ["model2", "one_rank", "back4"])
def test_encdec_checkpoint_restores_bit_equal(ranks, where):
    """The encoder-decoder's params and AdamW state placed on 'model' 4
    (the encoder's and the cross-attention's heads cut like the
    decoder's), restored at 'model' 2, on one rank, and from the 'model'
    2 save back at 4: every leaf equals the saved tree's bit for bit."""
    ck = [r["encdec_ckpt"] for r in ranks]
    want = ck[0]["saved"]
    assert any(k.startswith("encoder/") for k in want)
    holders = {"model2": ck[:2], "one_rank": ck[:1], "back4": ck}[where]
    for c in holders:
        got = c[where]
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert "Shard(dim=1)" in ck[0]["placements4"]
    for c in ck[:2]:
        m = c["model2_opt_m"]
        assert all(not m[k].any() and m[k].shape == v.shape
                   for k, v in want.items())


def test_pod_compressed_replica_groups_track_plain_pod(ranks):
    """The pod-compressed step on (pod 2, data 1, model 2) with one KV head
    and ``d_ff`` 129 (each whole on both 'model' ranks) keeps the logical
    error-feedback layout and tracks the plain pod step's losses within
    1e-4 relative."""
    plain = ranks[0]["pod_plain_group"]
    for r in ranks:
        tp = r["pod_tp_group"]
        assert tp["err"] == plain["err"]
        np.testing.assert_allclose(tp["losses"], plain["losses"], rtol=1e-4,
                                   atol=0)


def test_pod_compressed_on_model_learns(ranks):
    """(pod 2, data 1, model 2), 60 steps: the reference suite's learning
    contract against the plain one-rank step."""
    plain = np.asarray(W.one_rank_train(W.POD_OPT, W.POD_STEPS)[0])
    for r in ranks[1:]:             # every rank reports the same losses
        assert r["pod_learn"] == ranks[0]["pod_learn"]
    comp = np.asarray(ranks[0]["pod_learn"])
    plain0, plain1 = plain[:5].mean(), plain[-5:].mean()
    comp0, comp1 = comp[:5].mean(), comp[-5:].mean()
    assert plain1 < plain0 * 0.8
    assert comp1 < comp0 * 0.8
    assert abs(comp1 - plain1) < 0.25 * plain0


def test_pod_compressed_payload_is_the_logical_tree(ranks):
    """The tensor-parallel pod step compresses the logical gradients: its
    error-feedback buffers keep ``init_pod_error``'s leaves and shapes
    (the plain pod step's, leaf for leaf), and its losses track the plain
    pod step's on (pod 2, data 1) within 1e-4 relative (the payloads
    differ only by the rounding of the gradients' sums over 'model')."""
    plain = ranks[0]["pod_plain"]
    for r in ranks:
        tp = r["pod_tp"]
        assert tp["err"] == plain["err"]
        np.testing.assert_allclose(tp["losses"], plain["losses"], rtol=1e-4,
                                   atol=0)


def test_pod_compressed_error_feedback_matches_plain_pod(ranks):
    """The first step's error-feedback row, the residual of the int8 codes
    of the pod's flattened logical gradients, leaf by leaf: each
    tensor-parallel rank's equals the plain pod step's for the same pod
    wherever the two gradients round to the same code (within 1e-3 of the
    element's 2048-block scale), and differs by at most one quantum of
    that scale (plus 1e-3 of it) where a code flipped at a rounding
    boundary; at most 1 in 1000 elements may flip. A wrong gather dim or
    slice puts other values in most elements."""
    from repro_torch.training.grad_compression import BLOCK
    plain = {r["pod_plain"]["pod"]: r["pod_plain"]["err_first"]
             for r in ranks if "pod_plain" in r}
    assert sorted(plain) == [0, 1]
    for r in ranks:
        tp = r["pod_tp"]
        want = plain[tp["pod"]]
        assert sorted(tp["err_first"]) == sorted(want)
        scale = np.repeat(W.pod_block_scales(tp["pod"]), BLOCK)
        off, flips = 0, 0
        for k in sorted(want):
            n = want[k].size
            s = scale[off:off + n].reshape(want[k].shape)
            diff = np.abs(tp["err_first"][k] - want[k])
            assert np.all(diff <= 1.001 * s), f"rank {r['rank']} {k}"
            flips += int(np.sum(diff > 1e-3 * s))
            off += n
        assert flips <= off // 1000, (r["rank"], flips, off)


def test_trainer_resumes_to_the_same_losses(ranks):
    for r in ranks[:2]:
        assert len(r["trainer_through"]) == 4
        assert r["trainer_resumed"] == r["trainer_through"]
    assert "trainer_through" not in ranks[2]


def test_fsdp_placement_is_refused(ranks):
    for r in ranks:
        assert r["fsdp_raised"].startswith(
            "not ported yet: FSDP (ZeRO-3) over 'data'")
