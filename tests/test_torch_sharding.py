"""Port vs reference: ``distributed/sharding`` rules.

``logical_to_mesh``, ``make_param_shardings``, ``quantized_tensor_shardings``
and ``make_cache_shardings`` give the reference's specs, on rank-free meshes
(``jax.sharding.AbstractMesh`` there, ``sharding.AbstractMesh`` here), for
every leaf of all ten reduced configs' param tree, serving-format tree and
cache tree (contiguous and paged), on seven mesh shapes. Both packages'
trees go through both rule sets: the reference's own shape trees
(``jax.eval_shape``, stacked ``periods``) and the port's own unrolled
trees. Plus the fixed cases of ``tests/test_distributed.py`` and DTensor
placements.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.distributed import sharding as jsh
from repro.models.model import build_model as jax_build_model
from repro.quant import apply as japply
from repro.quant.qtypes import QuantizedTensor as JQT
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as tsh
from repro_torch.models.model import build_model
from repro_torch.quant import apply as tapply
from repro_torch.quant.qtypes import QuantizedTensor

MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2, 2), ("pod", "data", "model")), ((1, 8), ("data", "model")),
          ((8, 1), ("data", "model"))]


def _meshes(i):
    shape, names = MESHES[i]
    return (jax.sharding.AbstractMesh(shape, names),
            tsh.AbstractMesh(shape, names))


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k in tree:
            yield from _paths(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _meta(tree):
    """A reference shape tree as meta tensors with the same paths."""
    return jax.tree_util.tree_map(
        lambda x: torch.empty(tuple(x.shape), device="meta"), tree)


def _norm(spec, ndim):
    """A spec padded with None to ``ndim`` entries (a PartitionSpec may be
    shorter than its array's rank)."""
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _jax_model(arch):
    return jax_build_model(jax_get_config(arch, reduced=True))


def _assert_same(jsh_tree, tsh_tree, shapes):
    n = 0
    for path, ts in _paths(tsh_tree):
        if not isinstance(ts, tsh.MeshSharding):
            continue
        js = _get(jsh_tree, path)
        nd = len(_get(shapes, path).shape)
        assert _norm(js.spec, nd) == _norm(ts.spec, nd), (path, js.spec,
                                                          ts.spec)
        n += 1
    assert n > 0


@pytest.mark.parametrize("mesh_i", range(len(MESHES)),
                         ids=lambda i: "x".join(map(str, MESHES[i][0])))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_reference_on_the_same_trees(arch, mesh_i):
    jmesh, tmesh = _meshes(mesh_i)
    jm = _jax_model(arch)
    params = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    serving = japply.quantized_param_shapes(params, 4)
    serving8 = japply.quantized_param_shapes(params, 8)
    cache = jm.cache_shapes(2, 16)
    for tree, fn in ((params, "p"), (serving, "p"), (serving8, "p"),
                     (cache, "c"), (cache, "paged")):
        if fn == "p":
            want = jsh.make_param_shardings(jmesh, tree)
            got = tsh.make_param_shardings(tmesh, _meta(tree))
        else:
            want = jsh.make_cache_shardings(jmesh, tree, paged=fn == "paged")
            got = tsh.make_cache_shardings(tmesh, _meta(tree),
                                           paged=fn == "paged")
        _assert_same(want, got, tree)


def _sds(tree):
    """A port tree as reference shape structs with the same paths."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sds(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return jax.ShapeDtypeStruct(tuple(tree.shape), np.float32)
    return tree


@pytest.mark.parametrize("mesh_i", [0, 3, 4])
@pytest.mark.parametrize("arch", list_archs())
def test_port_trees_get_the_reference_specs(arch, mesh_i):
    """The port's own (unrolled) param, serving and cache trees through
    both rule sets: equal specs for every leaf."""
    jmesh, tmesh = _meshes(mesh_i)
    tm = build_model(get_config(arch, reduced=True))
    tparams = tm.init(torch.Generator().manual_seed(0), device="cpu")
    cache = tm.init_cache(2, 16, device="meta")
    cache = {k: v for k, v in cache.items() if k != "pos"}  # a host int
    for ttree, kind in ((tparams, "p"),
                        (tapply.quantized_param_shapes(tparams, 4), "p"),
                        (tapply.quantized_param_shapes(tparams, 8), "p"),
                        (cache, "c"), (cache, "paged")):
        if kind == "p":
            want = jsh.make_param_shardings(jmesh, _sds(ttree))
            got = tsh.make_param_shardings(tmesh, ttree)
        else:
            want = jsh.make_cache_shardings(jmesh, _sds(ttree),
                                            paged=kind == "paged")
            got = tsh.make_cache_shardings(tmesh, ttree,
                                           paged=kind == "paged")
        _assert_same(want, got, ttree)


def _qt_pair(rng, shape, bits):
    """A reference and a port QuantizedTensor of the same shapes."""
    from repro.quant.qtypes import from_codes as jfrom
    from repro_torch.quant.qtypes import from_codes as tfrom
    codes = rng.integers(-7, 8, size=shape).astype(np.int8)
    scale = np.ones((shape[0], 1), np.float32)
    return (jfrom(jax.numpy.asarray(codes), jax.numpy.asarray(scale), bits),
            tfrom(torch.from_numpy(codes), torch.from_numpy(scale), bits))


@pytest.mark.parametrize("mesh_i", range(len(MESHES)),
                         ids=lambda i: "x".join(map(str, MESHES[i][0])))
def test_quantized_tensor_shardings_equal_reference(mesh_i):
    jmesh, tmesh = _meshes(mesh_i)
    rng = np.random.default_rng(0)
    paths = [("stack", "periods", "b0", "attn", "wq", "w"),
             ("stack", "periods", "b0", "attn", "wo", "w"),
             ("stack", "periods", "b0", "moe", "wi", "w"),
             ("lm_head", "w"), ("stack", "periods", "b0", "tm", "w_lora_b",
                                "w"),
             ("stack", "periods", "b0", "cm", "wv", "w")]
    for shape in ((64, 32), (128, 256), (16, 48), (256, 64)):
        for bits in (4, 8):
            jq, tq = _qt_pair(rng, shape, bits)
            assert isinstance(jq, JQT) and isinstance(tq, QuantizedTensor)
            for path in paths:
                jd, js = jsh.quantized_tensor_shardings(jmesh, path, jq)
                td, ts = tsh.quantized_tensor_shardings(tmesh, path, tq)
                assert _norm(jd.spec, 2) == _norm(td.spec, 2), (path, shape)
                assert _norm(js.spec, 2) == _norm(ts.spec, 2), (path, shape)


def test_lora_tp_environment_switch(monkeypatch):
    jmesh, tmesh = _meshes(0)
    path = ("stack", "periods", "b0", "tm", "w_lora_b", "w")
    leaf = torch.empty(4, 64, 64, device="meta")
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("REPRO_LORA_TP", raising=False)
        else:
            monkeypatch.setenv("REPRO_LORA_TP", env)
        want = jsh.logical_to_mesh(jsh.param_sharding_rules(path, leaf),
                                   leaf.shape, jmesh, jsh._PARAM_RULES)
        got = tsh.logical_to_mesh(tsh.param_sharding_rules(path, leaf),
                                  leaf.shape, tmesh, tsh._PARAM_RULES)
        assert _norm(want, 3) == _norm(got, 3)


def test_fixed_cases_of_the_reference_suite():
    """``tests/test_distributed.py::test_param_sharding_rules`` on the
    port."""
    _, mesh = _meshes(0)
    S = lambda *s: torch.empty(s, device="meta")   # noqa: E731
    fake = {
        "attn": {"wq": {"w": S(64, 128)}, "wo": {"w": S(128, 64)}},
        "moe": {"wi": {"w": S(8, 64, 32)}, "router": {"w": S(64, 8)}},
        "moe_odd": {"moe": {"wi": {"w": S(6, 64, 32)}}},
        "periods": {"ffn": {"wi": {"w": S(3, 64, 32)}}},
        "embedding": {"embedding": S(256, 64)},
        "norm": {"gain": S(64)},
        "lm_head": {"w": S(64, 256)},
    }
    sh = tsh.make_param_shardings(mesh, fake)
    assert sh["attn"]["wq"]["w"].spec == ("data", "model")
    assert sh["attn"]["wo"]["w"].spec == ("model", "data")
    assert sh["moe"]["wi"]["w"].spec[:2] == ("model", "data")
    assert sh["moe_odd"]["moe"]["wi"]["w"].spec == (None, "data", "model")
    assert sh["periods"]["ffn"]["wi"]["w"].spec == (None, "data", "model")
    assert sh["embedding"]["embedding"].spec == ("model", "data")
    assert sh["norm"]["gain"].spec == (None,)
    assert sh["lm_head"]["w"].spec == ("data", "model")


def test_logical_to_mesh_divisibility_and_reuse():
    _, mesh = _meshes(4)                       # pod 2, data 2, model 2
    assert tsh.logical_to_mesh(("batch", "seq", "embed"), (8, 3, 5),
                               mesh) == (("pod", "data"), None, None)
    assert tsh.logical_to_mesh(("batch",), (6,), mesh) == ("data",)
    assert tsh.logical_to_mesh(("batch",), (3,), mesh) == (None,)
    # one mesh axis never serves two dims
    assert tsh.logical_to_mesh(("heads", "ff"), (4, 4), mesh) == \
        ("model", None)


def test_to_placements_order():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:                                # names are all it reads
        mesh_dim_names = ("pod", "data", "model")
    assert tsh.to_placements((("pod", "data"), "model"), _Mesh()) == \
        (Shard(0), Shard(0), Shard(1))
    assert tsh.to_placements((None, "data"), _Mesh()) == \
        (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        tsh.to_placements((("data", "pod"),), _Mesh())


def test_shard_index_tiles_in_mesh_order():
    """A shard's slices: mesh dims sharding one tensor dim split it major
    to minor in mesh order (as DTensor lays it out), and the shards of all
    coordinates tile the tensor."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = (2, 2)
    got = {c: tsh.shard_index((8, 4), (Shard(0), Shard(0)), sizes, c)
           for c in ((0, 0), (0, 1), (1, 0), (1, 1))}
    assert [got[c][0] for c in ((0, 0), (0, 1), (1, 0), (1, 1))] == \
        [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    assert all(got[c][1] == slice(0, 4) for c in got)
    t = torch.arange(48).reshape(8, 6)
    seen = torch.zeros_like(t)
    for c in ((0, 0), (0, 1), (1, 0), (1, 1)):
        seen[tsh.shard_index(t.shape, (Shard(1), Replicate()), sizes, c)] += 1
    assert torch.equal(seen, torch.full_like(t, 2))   # replicated twice
