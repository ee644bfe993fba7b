"""Reshard-on-restore across rank counts (the reference's
``tests/test_distributed.py::test_elastic_checkpoint_reshard`` and
``tests/test_checkpoint_quantized.py::test_reshard_on_restore_*``).

Four gloo ranks place a tree on a 4-rank elastic mesh and save it (the
save gathers the DTensor leaves; rank 0 writes); two ranks, a new group,
restore it onto a 2-rank elastic mesh: the training state
(``restore(shardings=)``) and the quantized serving tree
(``restore_serving(mesh=)``) come back bit-exact. A checkpoint written by
the reference package restores onto the 2-rank port mesh bit-exact, and
an engine staging the placed tree (gathered whole on each rank) serves the
same greedy tokens as one on the unplaced tree, for int4 and int8.
"""
import dataclasses

import jax
import numpy as np

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.quant import apply as japply
from repro_torch.distributed.group import run_local

_TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)

_COMMON = '''
import dataclasses
import numpy as np, torch
import torch.distributed as dist
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.distributed.sharding import (gather_tree,
                                              make_param_shardings,
                                              reshard_serving_tree)
from repro_torch.models.model import build_model
from repro_torch.quant.apply import quantize_params_serving
from repro_torch.runtime.elastic import make_elastic_mesh
from repro_torch.training.optimizer import adamw_init

TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)

def tiny():
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **TINY)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")

def flat(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k], path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in flat(v, path + (str(i),))]
    return [("/".join(path), tree)]

def host(tree):
    return [(k, np.asarray(v.detach().numpy()) if torch.is_tensor(v)
             else v) for k, v in flat(gather_tree(tree))]
'''

_SAVE = _COMMON + '''
def main(ckpt):
    torch.set_num_threads(1)
    model, params = tiny()
    mesh = make_elastic_mesh(4, prefer_model=2)     # (2, 2) data x model
    opt = adamw_init(params)
    placed = (reshard_serving_tree(params, mesh),
              reshard_serving_tree(opt, mesh))
    ck = Checkpointer(ckpt + "/train", async_save=False)
    ck.save(3, *placed)
    out = {}
    for bits in (4, 8):
        q, meta = quantize_params_serving(params, bits, "squant")
        Checkpointer(ckpt + f"/w{bits}", async_save=False).save_serving(
            1, reshard_serving_tree(q, mesh), quant_meta=meta)
        out[bits] = host(q)
    dist.barrier()
    shard = placed[0]["stack"]["list"][0]["b0"]["attn"]["wq"]["w"]
    return (tuple(mesh.shape), tuple(shard.to_local().shape), host(params),
            host(opt), out)
'''

_RESTORE = _COMMON + '''
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine
from repro_torch.serving.weights import WeightStore

def toks(model, tree, bits):
    eng = ServeEngine(model, cfg=ServeConfig(
        max_batch=2, max_len=32, quantize_weights="squant",
        weight_bits=bits), store=WeightStore(serving_params=tree,
                                             device="cpu"), device="cpu")
    return [c.tokens for c in eng.generate(
        [Request(prompt=[1, 2, 3], max_new_tokens=6, request_id=i)
         for i in range(2)])]

def main(ckpt, jax_ckpt):
    torch.set_num_threads(1)
    model, params = tiny()
    mesh = make_elastic_mesh(2, prefer_model=1)     # (2, 1) data x model
    opt = adamw_init(params)
    sh = (make_param_shardings(mesh, params), make_param_shardings(mesh, opt))
    p, o, step = Checkpointer(ckpt + "/train").restore(
        3, shardings=sh, template=(params, opt), device="cpu")
    shard = p["stack"]["list"][0]["b0"]["attn"]["wq"]["w"]
    out = {"train": (step, host(p), host(o),
                     tuple(shard.to_local().shape))}
    for bits in (4, 8):
        expect = {"quantize_weights": "squant", "weight_bits": bits}
        q, meta, _ = Checkpointer(ckpt + f"/w{bits}").restore_serving(
            expect=expect, mesh=mesh)
        unplaced, _, _ = Checkpointer(ckpt + f"/w{bits}").restore_serving(
            device="cpu")
        out[bits] = (host(q), toks(model, q, bits),
                     toks(model, unplaced, bits))
    jq, jmeta, _ = Checkpointer(jax_ckpt).restore_serving(mesh=mesh)
    out["jax"] = host(jq)
    return out
'''


def _jax_tree(tmp_path):
    cfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                              **_TINY)
    params = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    q, meta = japply.quantize_params_serving(params, 4, "squant")
    d = str(tmp_path / "jax")
    JCheckpointer(d, async_save=False).save_serving(2, q, quant_meta=meta)
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(q))[0]
    return d, {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in kp): np.asarray(a) for kp, a in flat}


def _equal(a, b):
    assert [k for k, _ in a] == [k for k, _ in b]
    for (k, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_save_on_four_ranks_restore_on_two(tmp_path):
    ckpt = str(tmp_path / "ck")
    saved = run_local(_SAVE, 4, backend="gloo", device="cpu", args=(ckpt,),
                      timeout=300, store_dir=str(tmp_path))
    mesh_shape, shard_shape, params, opt, quant = saved[0]
    assert mesh_shape == (2, 2) and shard_shape == (16, 16)   # of (32, 32)
    jax_dir, jax_leaves = _jax_tree(tmp_path)
    res = run_local(_RESTORE, 2, backend="gloo", device="cpu",
                    args=(ckpt, jax_dir), timeout=300,
                    store_dir=str(tmp_path))
    for out in res:
        step, p, o, shard = out["train"]
        assert step == 3 and shard == (16, 32)           # (32, 32) over 2
        _equal(p, params)
        _equal(o, opt)
        for bits in (4, 8):
            q, got, want = out[bits]
            _equal(q, quant[bits])
            assert got == want and len(got) == 2 and len(got[0]) == 6
        assert [k for k, _ in out["jax"]] == sorted(jax_leaves)
        for k, x in out["jax"]:
            np.testing.assert_array_equal(x, jax_leaves[k], err_msg=k)
