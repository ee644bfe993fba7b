"""Port vs reference: ``models/moe`` (routing, capacity, dispatch/combine,
the expert products on dense and quantized banks, the aux loss), the
pipeline's native route for ``(experts, in, out)`` banks, and
``convert.from_jax_params`` on a reference MoE tree.

Tolerances: gate indices equal; outputs and the aux loss within 1e-5
(float32); codes and scales of quantized banks bit-identical."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.models import moe as jmoe
from repro.quant import apply as japply
from repro_torch import convert
from repro_torch.core import pipeline
from repro_torch.kernels import ops as tops
from repro_torch.models import moe as tmoe
from repro_torch.quant import apply as tapply
from repro_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)
TOL = 1e-5


def _params(e, d=32, ff=48, kind="swiglu", seed=0):
    """(reference moe params, the same converted to torch on the CPU)."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, ff, e, kind)
    return jp, convert.from_jax_params(jax.device_get(jp), device="cpu")


def _x(b, s, d=32, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, d)).astype(
        np.float32)


def _both(jp, tp, x, **kw):
    yj, aj = jmoe.moe_ffn(jp, jnp.asarray(x), **kw)
    yt, at = tmoe.moe_ffn(tp, torch.from_numpy(x), **kw)
    return (np.asarray(yj), float(aj)), (yt.numpy(), float(at))


def _gates(jp, tp, x, top_k):
    """Each package's (renormalized gate values, gate indices) on the same
    tokens."""
    xt = x.reshape(-1, x.shape[-1])
    logits = (jnp.asarray(xt) @ jp["router"]["w"]).astype(jnp.float32)
    jv, ji = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), top_k)
    jv = jv / jnp.maximum(jv.sum(-1, keepdims=True), 1e-9)
    _, tv, ti = tmoe.route(tp["router"], torch.from_numpy(xt), top_k)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


ROUTES = [(4, 2), (8, 2), (8, 6)]


@pytest.mark.parametrize("e,k", ROUTES)
@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("b,s", [(1, 7), (3, 5), (2, 16)])
def test_moe_ffn_equals_reference(e, k, dropless, b, s):
    jp, tp = _params(e)
    x = _x(b, s)
    (jv, ji), (tv, ti) = _gates(jp, tp, x, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    (yj, aj), (yt, at) = _both(jp, tp, x, n_experts=e, top_k=k,
                               dropless=dropless)
    np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)
    assert abs(at - aj) <= TOL


@pytest.mark.parametrize("kind", ["geglu", "gelu", "relu"])
def test_moe_ffn_other_ffn_kinds(kind):
    jp, tp = _params(4, kind=kind)
    x = _x(2, 6)
    (yj, aj), (yt, at) = _both(jp, tp, x, n_experts=4, top_k=2, kind=kind)
    np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)
    assert abs(at - aj) <= TOL


@pytest.mark.parametrize("e,k", ROUTES)
def test_tied_probabilities_go_to_the_lower_index(e, k):
    """A zero router makes every probability 1/E: the top-k are experts
    0..k-1, as ``lax.top_k`` gives them; capacity competition then follows
    token order."""
    jp, tp = _params(e)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    x = _x(2, 5)
    (_, ji), (_, ti) = _gates(jp, tp, x, k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ti, np.tile(np.arange(k), (10, 1)))
    (yj, aj), (yt, at) = _both(jp, tp, x, n_experts=e, top_k=k)
    np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)
    assert abs(at - aj) <= TOL


def test_capacity_rounds_up_and_drops_tokens_as_the_reference():
    """t=4, k=2, E=4, cf=1.25: capacity ceil(2.5) = 3, and a tight factor
    drops tokens; both packages drop the same ones."""
    jp, tp = _params(4)
    x = _x(1, 4)
    for cf in (1.25, 0.5):
        (yj, _), (yt, _) = _both(jp, tp, x, n_experts=4, top_k=2,
                                 capacity_factor=cf)
        np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)


def test_token_chunk_blocking(monkeypatch):
    """Above 2 * TOKEN_CHUNK tokens the sequence routes in TOKEN_CHUNK
    blocks (capacity per block), as in the reference."""
    monkeypatch.setattr(jmoe, "TOKEN_CHUNK", 4)
    monkeypatch.setattr(tmoe, "TOKEN_CHUNK", 4)
    jp, tp = _params(4)
    x = _x(2, 8)                       # t = 16 > 8, 4 blocks of 4
    (yj, aj), (yt, at) = _both(jp, tp, x, n_experts=4, top_k=2)
    np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)
    assert abs(at - aj) <= TOL
    monkeypatch.setattr(tmoe, "TOKEN_CHUNK", 8192)
    (y1, _) = tmoe.moe_ffn(tp, torch.from_numpy(x), n_experts=4, top_k=2)
    assert not np.allclose(y1.numpy(), yt)      # blocking changed routing


def test_bfloat16_activations_keep_their_dtype():
    _, tp = _params(4)
    x = torch.from_numpy(_x(2, 5)).to(torch.bfloat16)
    y, aux = tmoe.moe_ffn(tp, x, n_experts=4, top_k=2)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


# ---------------------------------------------------------------------------
# quantized banks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("e,k", [(4, 2), (8, 6)])
def test_moe_ffn_on_quantized_tensor_banks(bits, e, k):
    """``quantize_tree`` banks ((E*out, in) codes): codes and scales
    bit-identical to the reference pipeline's, outputs within 1e-5."""
    jp, tp = _params(e, d=64, ff=128)
    jq, _ = jax_quantize_tree(jp, method="squant", bits=bits,
                              group_size=32, backend="ref")
    tq, _ = pipeline.quantize_tree(tp, method="squant", bits=bits,
                                   group_size=32, device="cpu")
    for name in ("wi", "wg", "wdown"):
        a, b = jq[name]["w"], tq[name]["w"]
        assert isinstance(b, QuantizedTensor) and b.shape == tuple(a.shape)
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    assert isinstance(tq["router"]["w"], torch.Tensor)
    x = _x(2, 6, d=64)
    for dropless in (False, True):
        (yj, aj), (yt, at) = _both(jq, tq, x, n_experts=e, top_k=k,
                                   dropless=dropless)
        np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)
        assert abs(at - aj) <= TOL


@pytest.mark.parametrize("bits", [4, 8])
def test_moe_ffn_on_serving_format_banks(bits):
    """``quant.apply``'s ``w_q``/``w_q4`` banks ((E, out, in) codes):
    leaves bit-identical to the reference's, outputs within 1e-5."""
    jp, tp = _params(8, d=64, ff=128)
    jq = japply.quantize_params_sharded(jp, bits)
    tq = tapply.quantize_params_sharded(tp, bits)
    key = "w_q4" if bits <= 4 else "w_q"
    for name in ("wi", "wg", "wdown"):
        np.testing.assert_array_equal(tq[name][key].numpy(),
                                      np.asarray(jq[name][key]))
        np.testing.assert_array_equal(tq[name]["w_scale"].numpy(),
                                      np.asarray(jq[name]["w_scale"]))
    assert "w" in tq["router"]
    x = _x(3, 4, d=64)
    (yj, aj), (yt, at) = _both(jq, tq, x, n_experts=8, top_k=6)
    np.testing.assert_allclose(yt, yj, rtol=TOL, atol=TOL)
    assert abs(at - aj) <= TOL


def test_expert_view_is_a_zero_copy_slice():
    _, tp = _params(4, d=64, ff=128)
    tq, _ = pipeline.quantize_tree(tp, bits=8, group_size=32, device="cpu")
    qt = tq["wi"]["w"]
    serving = tapply.quantize_params_sharded(tp, 4)["wi"]
    for e in range(4):
        v = tapply.expert_view(tq["wi"], e, 4)
        assert v.shape == (128, 64)
        assert v.data.data_ptr() == qt.data.data_ptr() + e * 128 * 64
        assert torch.equal(v.dequantize(), qt.dequantize()[e * 128:
                                                           (e + 1) * 128])
        s = tapply.expert_view(serving, e, 4)
        assert s.bits == 4 and s.shape == (128, 64)
        assert s.data.data_ptr() == serving["w_q4"][e].data_ptr()


def test_expert_matmul_plain_version_is_the_dequantized_bank():
    """On the CPU the quantized bank's product is the reference's form:
    the bank dequantized in the activation dtype, then a batched matmul."""
    _, tp = _params(4, d=64, ff=128)
    tq, _ = pipeline.quantize_tree(tp, bits=8, group_size=32, device="cpu")
    x = torch.from_numpy(_x(4, 3, d=64))
    got = tmoe.expert_matmul(tq["wi"], x)
    w = tq["wi"]["w"].dequantize().reshape(4, 128, 64)
    assert torch.equal(got, torch.einsum("ecd,efd->ecf", x, w))
    with pytest.raises(ValueError):
        tops.expert_matmul(x, tq["wi"], backend="cuda")


# ---------------------------------------------------------------------------
# the native route of the pipeline for expert banks
# ---------------------------------------------------------------------------

def test_plan_buckets_routes_expert_banks_native():
    leaves = [((64, 2048, 1408), "float32", 4, True),     # wi
              ((64, 2048, 1408), "float32", 4, True),     # wg
              ((64, 1408, 2048), "float32", 4, True),     # wdown
              ((2048, 2048), "float32", 4, True)]         # attention
    plans = pipeline.plan_buckets(leaves, "squant", 128, native=True)
    assert [(p.key, p.entries, p.route) for p in plans] == [
        (((90112, 2048), "float32", 128), [0, 1], "native"),
        (((131072, 1408), "float32", 128), [2], "native"),
        (((2048, 2048), "float32", 128), [3], "native")]
    assert all(p.chunks == [p.entries] for p in plans)
    stacked = pipeline.plan_buckets(leaves, "squant", 128, native=False)
    assert [p.route for p in stacked] == ["stacked"] * 3


@pytest.mark.parametrize("leaves,route", [
    ([((4, 256, 8), "float32", 4, False)], "stacked"),        # not contiguous
    ([((4, 256, 8), "bfloat16", 2, True)], "stacked"),        # not float32
    ([((4, 256, 8), "float32", 4, True),
      ((256, 32), "float32", 4, True)], "stacked"),           # two shapes
    ([((4, 256, 8), "float32", 4, True)] * 3, "native")])
def test_plan_buckets_expert_bank_conditions(leaves, route):
    (plan,) = pipeline.plan_buckets(leaves, "squant", 128, native=True)
    assert plan.route == route


def _force_native(monkeypatch):
    real = pipeline.plan_buckets
    monkeypatch.setattr(pipeline, "plan_buckets",
                        lambda leaves, m, g, native, **kw:
                        real(leaves, m, g, True, **kw))


@pytest.mark.parametrize("bits", [4, 8])
def test_native_route_on_expert_banks_equals_stacked_and_reference(
        monkeypatch, bits):
    """The native route planned as on the card (the wrappers take their
    plain versions on the CPU): every expert slice read as an (in, out)
    leaf, codes (E*out, in) and scales bit-identical to the stacked route
    and to the reference pipeline."""
    jp, _ = _params(8, d=256, ff=128)
    jtree = {"moe": jp, "attn": {"w": jnp.asarray(np.asarray(
        jax.random.normal(jax.random.PRNGKey(3), (256, 64))))}}
    ttree = convert.from_jax_params(jax.device_get(jtree), device="cpu")
    jq, _ = jax_quantize_tree(jtree, method="squant", bits=bits,
                              group_size=128, backend="ref")
    stacked, _ = pipeline.quantize_tree(ttree, bits=bits, group_size=128,
                                        device="cpu")
    _force_native(monkeypatch)
    native, rep = pipeline.quantize_tree(ttree, bits=bits, group_size=128,
                                         device="cpu")
    routes = {b.key: b.route for b in rep.buckets}
    assert routes == {"(64,256)x1 float32 g128": "native",
                      "(1024,256)x2 float32 g128": "native",
                      "(2048,128)x1 float32 gNone": "stacked"}
    for path in (("attn",), ("moe", "wi"), ("moe", "wg"),
                 ("moe", "wdown")):
        a, b, c = jq, stacked, native
        for k in path:
            a, b, c = a[k], b[k], c[k]
        a, b, c = a["w"], b["w"], c["w"]
        assert c.shape == b.shape == tuple(a.shape)
        for t in (b, c):
            np.testing.assert_array_equal(t.data.numpy(), np.asarray(a.data))
            np.testing.assert_array_equal(t.scale.numpy(),
                                          np.asarray(a.scale))


# ---------------------------------------------------------------------------
# convert
# ---------------------------------------------------------------------------

def test_from_jax_params_on_a_reference_moe_tree():
    """A reference MoE model's stacked tree: the layer axis unrolled, banks
    (E, in, out) bit for bit; its quantized tree: (E*out, in) codes."""
    from repro.configs import get_config
    from repro.models.model import build_model
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b",
                                         reduced=True), dtype="float32")
    jp = build_model(cfg).init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jax.device_get(jp), device="cpu")
    assert len(tp["stack"]["list"]) == cfg.n_layers
    for i, layer in enumerate(tp["stack"]["list"]):
        moe = layer["b0"]["moe"]
        for name in ("wi", "wg", "wdown", "router"):
            want = np.asarray(jp["stack"]["periods"]["b0"]["moe"][name]["w"])
            np.testing.assert_array_equal(moe[name]["w"].numpy(), want[i])
        assert moe["wi"]["w"].shape == (4, 64, 128)
    jq, _ = jax_quantize_tree(jax.tree_util.tree_map(
        lambda a: a[0], jp["stack"]["periods"]["b0"]["moe"]), bits=8,
        backend="ref")
    tq = convert.from_jax_params(jax.device_get(jq), device="cpu")
    w = tq["wdown"]["w"]
    assert isinstance(w, QuantizedTensor) and w.shape == (4 * 64, 128)
    np.testing.assert_array_equal(w.data.numpy(),
                                  np.asarray(jq["wdown"]["w"].data))
