"""Port vs reference: sharded ``quantize_tree(mesh=)`` on 2 and 4 CPU ranks.

Each rank (a process of a gloo group started by
``distributed.group.run_local``) quantizes its row slab of every bucket;
the gathered codes and scales must equal the reference's ``quantize_tree``
bit for bit, on trees of dense leaves (a bucket whose rows do not divide
the rank count), an expert bank and a conv kernel, int4 and int8, squant,
squant_ek and rtn, ``dequantize=True``, and with the native route forced
(slabs that start and end inside a leaf, read as column ranges). Also:
``QuantReport.shards`` equals the reference's ``shard_rows`` accounting,
one synchronization a tree, and the validation errors.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.dispatch import shard_rows as jax_shard_rows
from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro_torch.core.dispatch import shard_rows, slab_pieces
from repro_torch.distributed.group import run_local

from conftest import grid_weights

CASES = [dict(method="squant", bits=4, group_size=16),
         dict(method="squant", bits=8, group_size=32),
         dict(method="squant_ek", bits=4, group_size=16),
         dict(method="rtn", bits=8, group_size=None),
         dict(method="squant", bits=4, group_size=16, dequantize=True)]

_CHILD = '''
import numpy as np, torch
from repro_torch.core import pipeline
from repro_torch.distributed.sharding import gather_tree
from repro_torch.launch.mesh import make_quantize_mesh

def _np(x):
    return x.detach().cpu().numpy()

def main(trees, cases):
    torch.set_num_threads(1)
    syncs = []
    sync = pipeline._sync
    pipeline._sync = lambda d: (syncs.append(1), sync(d))
    mesh = make_quantize_mesh()
    out = []
    for native in (False, True):
        orig = pipeline.plan_buckets
        if native:   # the CPU takes the kernels' plain versions
            pipeline.plan_buckets = lambda l, m, g, native: orig(l, m, g, True)
        for name, tree in trees.items():
            for case in cases:
                if native and case["method"] == "rtn":
                    continue
                del syncs[:]
                t = {k: {kk: torch.from_numpy(vv) for kk, vv in v.items()}
                     for k, v in tree.items()}
                q, rep = pipeline.quantize_tree(t, device="cpu", mesh=mesh,
                                                **case)
                routes = sorted({b.route for b in rep.buckets})
                q = gather_tree(q)
                leaves = {}
                for k, v in q.items():
                    for kk, vv in v.items():
                        if hasattr(vv, "scale"):
                            leaves[k + "/" + kk] = (_np(vv.data),
                                                    _np(vv.scale))
                        else:
                            leaves[k + "/" + kk] = (_np(vv), None)
                out.append((native, name, case, leaves,
                            [(s.device, s.rows, s.pad_rows)
                             for s in rep.shards],
                            (rep.mesh_axis, rep.mesh_size), len(syncs),
                            routes, [b.key for b in rep.buckets]))
        pipeline.plan_buckets = orig
    return out
'''


def _trees():
    rng = np.random.default_rng(0)
    dense = {f"blk{i}": {"w": grid_weights(rng, 48, 9)} for i in range(3)}
    dense["wide"] = {"w": grid_weights(rng, 64, 40)}
    dense["norm"] = {"gain": np.ones(16, np.float32)}
    bank = grid_weights(rng, 3 * 32, 24).reshape(3, 32, 24)
    conv = grid_weights(rng, 9 * 4, 8).reshape(3, 3, 4, 8)
    return {"dense": dense, "bank": {"moe": {"w": bank}},
            "conv": {"conv": {"w_conv": conv}}}


def _jax(tree, case):
    t = {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in tree.items()}
    return jax_quantize_tree(t, backend="ref", **case)


def _expected_shards(report, ndev):
    """The reference's per-device accounting of an unsharded run's
    buckets: ``shard_rows`` of each bucket dispatch's rows, summed."""
    acc = [[0, 0] for _ in range(ndev)]
    for b in report.buckets:
        m = int(re.match(r"\((\d+),", b.key).group(1))
        for d, (r, p) in enumerate(jax_shard_rows(m * b.num_layers, ndev)):
            acc[d][0] += r
            acc[d][1] += p
    return [(d, r, p) for d, (r, p) in enumerate(acc)]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_quantize_tree_is_bit_identical_to_reference(world,
                                                             tmp_path):
    trees = _trees()
    results = run_local(_CHILD, world, backend="gloo", device="cpu",
                        args=(trees, CASES), timeout=300,
                        store_dir=str(tmp_path))
    assert len(results) == world
    ref = {}
    n_native = 0
    for rank, res in enumerate(results):
        assert len(res) == len(results[0])
        for native, name, case, leaves, shards, axis, syncs, routes, keys \
                in res:
            key = (name, tuple(sorted(case.items())))
            if key not in ref:
                ref[key] = _jax(trees[name], case)
            jq, jrep = ref[key]
            assert axis == ("data", world)
            assert syncs == 1                       # one sync a tree
            n_native += "native" in routes
            assert native or routes == ["stacked"]
            assert shards == _expected_shards(jrep, world), (name, case)
            for key, (data, scale) in leaves.items():
                k, kk = key.split("/")
                want = jq[k][kk]
                if scale is None:
                    np.testing.assert_array_equal(data, np.asarray(want))
                else:
                    np.testing.assert_array_equal(data,
                                                  np.asarray(want.data))
                    np.testing.assert_array_equal(scale,
                                                  np.asarray(want.scale))
    assert n_native > 0


def test_shard_rows_equals_reference():
    for rows in list(range(0, 70)) + [127, 128, 129, 4095, 4096, 12800 * 3]:
        for ndev in (1, 2, 3, 4, 7, 8, 16):
            assert shard_rows(rows, ndev) == jax_shard_rows(rows, ndev)


def test_slab_pieces_cover_the_rows():
    for m in (1, 3, 8):
        for b in (1, 2, 5):
            for r0 in range(b * m + 1):
                for r1 in range(r0, b * m + 1):
                    pieces = slab_pieces(r0, r1, m)
                    assert len(pieces) <= 3
                    rows = [lb * m + c for b0, b1, c0, n in pieces
                            for lb in range(b0, b1)
                            for c in range(c0, c0 + n)]
                    assert rows == list(range(r0, r1)), (m, b, r0, r1)
