"""Port vs reference: ``quant/apply`` (the ``w_q``/``w_q4``/``w_scale``
serving format) and the qdict branch of ``models.layers.linear``.

The same weights (the reference's init, carried over bit for bit) go through
the reference's ``quantize_params_sharded`` and the port's: codes and scales
must be equal bit for bit for every bits x method x group case, on the
unrolled and on the stacked (``scan_layers=True``) tree. The qdict linear and
a whole tiny forward are held to the reference at ``rtol=atol=1e-4``
(float32) and ``2e-2`` (bfloat16). The card's cases are in
``tests/test_torch_reload_cuda.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models.model import build_model as jax_build_model
from repro.quant import apply as japply
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models.model import build_model
from repro_torch.models.transformer import unstack_stack
from repro_torch.quant import apply as tapply

torch.set_num_threads(1)

_TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)


def _jax_tiny(seed=0, scan=True):
    cfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                              scan_layers=scan, **_TINY)
    model = jax_build_model(cfg)
    return model, model.init(jax.random.PRNGKey(seed))


def _to_torch(tree):
    """A host reference tree as tensors, structure kept (a stacked
    ``{"periods": ...}`` stays stacked)."""
    return convert._convert(jax.device_get(tree), "cpu")


def _flat_jax(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_torch(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_torch(tree[k], path + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_torch(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def _assert_same_tree(jtree, ttree):
    fj, ft = _flat_jax(jtree), _flat_torch(ttree)
    assert sorted(fj) == sorted(ft)
    for k, a in fj.items():
        b = ft[k]
        assert str(b.dtype).replace("torch.", "") == str(a.dtype), k
        np.testing.assert_array_equal(b.numpy(), a, err_msg=k)


@pytest.fixture(scope="module", params=["unrolled", "stacked"])
def trees(request):
    model, jparams = _jax_tiny(scan=request.param == "stacked")
    return request.param, model, jparams, _to_torch(jparams)


@pytest.mark.parametrize("group_size", [128, None])
@pytest.mark.parametrize("method", ["squant", "rtn"])
@pytest.mark.parametrize("bits", [8, 4, 3])
def test_codes_and_scales_bit_identical(trees, bits, method, group_size):
    layout, _, jparams, tparams = trees
    jq = japply.quantize_params_sharded(jparams, bits, method=method,
                                        group_size=group_size)
    tq = tapply.quantize_params_sharded(tparams, bits, method=method,
                                        group_size=group_size)
    _assert_same_tree(jq, tq)
    key = "w_q4" if bits <= 4 else "w_q"
    wq = (tq["stack"]["periods"] if layout == "stacked"
          else tq["stack"]["list"][0])["b0"]["attn"]["wq"]
    assert set(wq) == {key, "w_scale"}
    assert tq["embedding"]["embedding"] is tparams["embedding"]["embedding"]


def test_serving_tree_and_meta_equal_reference(trees):
    _, _, jparams, tparams = trees
    jq, jm = japply.quantize_params_serving(jparams, 4, "squant")
    tq, tm = tapply.quantize_params_serving(tparams, 4, "squant")
    _assert_same_tree(jq, tq)
    assert tm.pop("quantize_ms") >= 0.0 and jm.pop("quantize_ms") >= 0.0
    assert tm == jm
    assert tapply.quant_tree_meta(8, "rtn", None, quantize_ms=1.5) == \
        japply.quant_tree_meta(8, "rtn", None, quantize_ms=1.5)


def test_quantized_param_shapes(trees):
    _, model, jparams, tparams = trees
    for bits in (8, 4):
        jshape = japply.quantized_param_shapes(
            jax.eval_shape(model.init, jax.random.PRNGKey(0)), bits)
        meta = _flat_torch(tapply.quantized_param_shapes(_meta(tparams),
                                                         bits))
        fj = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in kp): v
              for kp, v in jax.tree_util.tree_flatten_with_path(jshape)[0]}
        assert sorted(fj) == sorted(meta)
        for k, s in fj.items():
            assert tuple(meta[k].shape) == tuple(s.shape), k
            assert str(meta[k].dtype).replace("torch.", "") == str(s.dtype)
            assert meta[k].is_meta


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return tree.to("meta")


def test_is_quantized_tree(trees):
    _, _, jparams, tparams = trees
    tq = tapply.quantize_params_sharded(tparams, 8)
    jq = japply.quantize_params_sharded(jparams, 8)
    for t, j in ((tparams, jparams), (tq, jq)):
        assert tapply.is_quantized_tree(t) == japply.is_quantized_tree(j)
    assert tapply.is_quantized_tree(tq) and \
        not tapply.is_quantized_tree(tparams)
    assert tapply.is_quantized_tree([{"a": {"w_q4": 0}}])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_kernel_bit_identical(trees, bits, dtype):
    _, _, jparams, tparams = trees
    jq = japply.quantize_params_sharded(jparams, bits)
    tq = tapply.quantize_params_sharded(tparams, bits)
    jd, td = jq["stack"], tq["stack"]
    jd = (jd["periods"] if "periods" in jd else jd["list"][1])["b0"]["ffn"]
    td = (td["periods"] if "periods" in td else td["list"][1])["b0"]["ffn"]
    for name in ("wg", "wi", "wdown"):
        j = japply.dequant_kernel(jd[name], getattr(jnp, dtype))
        t = tapply.dequant_kernel(td[name], getattr(torch, dtype))
        np.testing.assert_array_equal(t.float().numpy(),
                                      np.asarray(j.astype(jnp.float32)))


def _qdict_pair(bits, seed=0, d_in=256, d_out=96):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d_in, d_out)) / np.sqrt(d_in)).astype(np.float32)
    x = rng.standard_normal((5, 3, d_in)).astype(np.float32)
    jq = japply.quantize_params_sharded({"p": {"w": jnp.asarray(w)}}, bits)
    tq = tapply.quantize_params_sharded({"p": {"w": torch.from_numpy(w)}},
                                        bits)
    return jq["p"], tq["p"], x


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("bits", [8, 4])
def test_qdict_linear_close_to_reference(bits, dtype, tol):
    jp, tp, x = _qdict_pair(bits)
    y_ref = jlayers.linear(jp, jnp.asarray(x).astype(getattr(jnp, dtype)))
    y = tlayers.linear(tp, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert y.shape == (5, 3, 96) and str(y.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(y_ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    # the qdict is served through a view of its own tensors, no copy
    qt = tapply.qdict_view(tp)
    key = "w_q4" if bits <= 4 else "w_q"
    assert qt.data is tp[key] and qt.scale is tp["w_scale"]
    assert qt.bits == bits and qt.shape == (96, 256)


def test_qdict_linear_by_position():
    """The verify forward's per-position linear goes through the same
    branch: each position's rows equal a one-position call."""
    _, tp, x = _qdict_pair(8)
    xt = torch.from_numpy(x)
    y = tlayers.linear_by_position(tp, xt)
    for j in range(xt.shape[1]):
        assert torch.equal(y[:, j:j + 1],
                           tlayers.linear(tp, xt[:, j:j + 1].contiguous()))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("layout", ["unrolled", "stacked"])
def test_tiny_forward_close_to_reference(layout, dtype, tol):
    model, jparams = _jax_tiny(scan=layout == "stacked")
    jq = japply.quantize_params_sharded(jparams, 8)
    tq = tapply.quantize_params_sharded(_to_torch(jparams), 8)
    if layout == "stacked":
        tq = dict(tq, stack=unstack_stack(tq["stack"], 2))
    jcfg = dataclasses.replace(model.cfg, dtype=dtype)
    tcfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                               scan_layers=False, **dict(_TINY, dtype=dtype))
    emb = jq["embedding"]["embedding"].astype(getattr(jnp, dtype))
    jq = dict(jq, embedding={"embedding": emb})
    tq = dict(tq, embedding={"embedding": tq["embedding"]["embedding"].to(
        getattr(torch, dtype))})
    tokens = np.random.default_rng(1).integers(0, 64, (2, 7))
    jl, _, _ = jax_build_model(jcfg).forward(
        jq, {"tokens": jnp.asarray(tokens)}, mode="train")
    tl, _ = build_model(tcfg).forward(tq, {"tokens": torch.from_numpy(tokens)},
                                      mode="train")
    np.testing.assert_allclose(tl.float().numpy(),
                               np.asarray(jl.astype(jnp.float32)),
                               rtol=tol, atol=tol)


def test_group_size_none_and_odd_leaves():
    """A stacked leaf with two stack dims and the whole-row path."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 3, 40, 24)).astype(np.float32)
    for bits, gs in ((8, None), (4, 16), (2, 128)):
        jq = japply.quantize_params_sharded({"x": {"w": jnp.asarray(w)}},
                                            bits, group_size=gs)
        tq = tapply.quantize_params_sharded({"x": {"w": torch.from_numpy(w)}},
                                            bits, group_size=gs)
        _assert_same_tree(jq, tq)
    # router and embedding paths are never quantized
    tree = {"router": {"w": torch.ones(4, 4)},
            "embedding": {"w": torch.ones(4, 4)}}
    assert tapply.quantize_params_sharded(tree, 8) == tree
