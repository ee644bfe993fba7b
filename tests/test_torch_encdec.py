"""Port vs reference: the encoder-decoder's modules — ``cross_attention``
(unmasked and under an encoder mask), ``apply_encoder``, the dtype
promotion of a bfloat16 query over a float32 encoder output, the
converter's unrolling of the reference's stacked encoder (its quantized
bank rows sliced back per layer) and the weight-decay mask of the encoder's
norm gains — at the reduced ``seamless-m4t-medium`` width (d_model 64, 4
heads of 16), inputs made with numpy from a seed.

float32 outputs agree within ``rtol=atol=1e-5``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.models import attention as jattn
from repro.models import transformer as jtr
from repro.models.model import build_model as jax_build_model
from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.model import build_model
from repro_torch.quant.qtypes import QuantizedTensor
from repro_torch.training import optimizer as topt

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(**over):
    kw = dict(dtype="float32", remat=False, **over)
    return (dataclasses.replace(jax_get_config(ARCH, reduced=True), **kw),
            dataclasses.replace(get_config(ARCH, reduced=True), **kw))


def _host(tree):
    return convert._convert(jax.device_get(tree), "cpu")


def _normal(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_matches_reference(masked):
    """Decoder rows (2, 7) over an encoder output of 5 frames: the
    unmasked form through the chunked prefill einsums, the masked one
    (frames past each row's length masked) through the grouped form."""
    jc, tc = _cfgs()
    jp = jattn.init_cross_attention(jax.random.PRNGKey(1), jc)
    tp = _host(jp)
    x, enc = _normal((2, 7, tc.d_model), 2), _normal((2, 5, tc.d_model), 3)
    mask = np.arange(5)[None, :] < np.array([[3], [5]]) if masked else None
    want = jattn.cross_attention(
        jp, jnp.asarray(x), jnp.asarray(enc), cfg=jc,
        enc_mask=None if mask is None else jnp.asarray(mask))
    got = tattn.cross_attention(
        tp, torch.from_numpy(x), torch.from_numpy(enc), cfg=tc,
        enc_mask=None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        # a masked frame changes nothing
        enc2 = enc.copy()
        enc2[0, 3:] = 7.0
        again = tattn.cross_attention(tp, torch.from_numpy(x),
                                      torch.from_numpy(enc2), cfg=tc,
                                      enc_mask=torch.from_numpy(mask))
        np.testing.assert_array_equal(again[0].numpy(), got[0].numpy())


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_promotes_a_bf16_query_like_reference(masked):
    """A bfloat16 query (the decoder's layer 0) over a float32 encoder
    output: the reference's ``einsum`` promotes to float32, and so does the
    port (torch's einsum would raise on mixed dtypes); outputs float32 and
    within 1e-5 of the reference."""
    jc, tc = _cfgs()
    jp = jattn.init_cross_attention(jax.random.PRNGKey(4), jc)
    tp = _host(jp)
    x = _normal((2, 3, tc.d_model), 5)
    enc = _normal((2, 4, tc.d_model), 6)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    mask = np.ones((2, 4), bool) if masked else None
    want = jattn.cross_attention(
        jp, jx, jnp.asarray(enc), cfg=jc,
        enc_mask=None if mask is None else jnp.asarray(mask))
    got = tattn.cross_attention(
        tp, tx, torch.from_numpy(enc), cfg=tc,
        enc_mask=None if mask is None else torch.from_numpy(mask))
    assert str(want.dtype) == "float32" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_apply_encoder_matches_reference(frames_dtype):
    """The reference's stacked encoder (two layers) unrolled by the
    converter: the encoder output of random frames within 1e-5 in float32,
    and in the frames' dtype (within 2e-2 of the largest in bfloat16)."""
    jc, tc = _cfgs()
    jenc = jtr.init_encoder(jax.random.PRNGKey(7), jc)
    tenc = convert.from_jax_params(jax.device_get({"encoder": jenc}),
                                   device="cpu")["encoder"]
    assert isinstance(tenc["layers"], list) and len(tenc["layers"]) == 2
    fr = _normal((2, 6, tc.d_model), 8)
    jfr = jnp.asarray(fr).astype(frames_dtype)
    tfr = torch.from_numpy(fr).to(getattr(torch, frames_dtype))
    want = jtr.apply_encoder(jenc, jfr, cfg=jc)
    got = ttr.apply_encoder(tenc, tfr, cfg=tc)
    assert str(got.dtype) == f"torch.{want.dtype}"
    w = np.asarray(want.astype(jnp.float32))
    g = got.float().numpy()
    if frames_dtype == "float32":
        np.testing.assert_allclose(g, w, **TOL)
    else:
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max()


def test_encoder_remat_changes_memory_not_numbers():
    """With ``remat`` each encoder layer runs under
    ``torch.utils.checkpoint``: the output and the gradients are the ones
    without it."""
    _, tc = _cfgs()
    tcr = dataclasses.replace(tc, remat=True)
    enc = ttr.init_encoder(torch.Generator().manual_seed(0), tc,
                           device="cpu")
    fr = torch.from_numpy(_normal((2, 6, tc.d_model), 9))

    def grads(cfg):
        live = topt.tree_map(lambda p: p.detach().requires_grad_(True), enc)
        with torch.enable_grad():
            out = ttr.apply_encoder(live, fr, cfg=cfg)
            gs = torch.autograd.grad(out.square().sum(),
                                     topt.tree_leaves(live))
        return out.detach(), gs

    out0, g0 = grads(tc)
    out1, g1 = grads(tcr)
    np.testing.assert_array_equal(out1.numpy(), out0.numpy())
    for a, b in zip(g0, g1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_init_shapes_equal_the_converted_reference_tree():
    """``LM.init`` of the port makes the tree the converter makes of the
    reference's: the decoder blocks with ``xln``/``xattn``, the encoder as
    a list of ``encoder_layers`` layers and its final norm."""
    jc, tc = _cfgs()
    jp = jax_build_model(jc).init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jax.device_get(jp), device="cpu")
    own = build_model(tc).init(torch.Generator().manual_seed(0),
                               device="cpu")
    shapes = topt.tree_map(lambda t: (tuple(t.shape), t.dtype), own)
    assert topt.tree_map(lambda t: (tuple(t.shape), t.dtype), tp) == shapes
    assert set(own["stack"]["list"][0]["b0"]) == {"ln1", "ln2", "attn",
                                                 "ffn", "xln", "xattn"}
    assert set(own["encoder"]) == {"layers", "final_norm"}
    assert len(own["encoder"]["layers"]) == tc.encoder_layers
    assert set(own["encoder"]["layers"][0]) == {"ln1", "attn", "ln2", "ffn"}
    assert set(own["encoder"]["layers"][0]["attn"]) == {"wq", "wk", "wv",
                                                       "wo"}
    np.testing.assert_array_equal(
        tp["encoder"]["layers"][1]["attn"]["wk"]["w"].numpy(),
        np.asarray(jp["encoder"]["layers"]["attn"]["wk"]["w"][1]))


def test_convert_slices_the_reference_encoder_banks_per_layer():
    """The reference quantizes each stacked encoder leaf ``(L, in, out)``
    as one ``(L·out, in)`` bank: the converter gives layer ``l`` its rows
    ``[l·out, (l+1)·out)`` of codes and scales, an ``(out, in)``
    QuantizedTensor, and leaves the norm gains' layer axis unrolled."""
    jc, _ = _cfgs(d_model=256, d_ff=256)
    jp = jax_build_model(jc).init(jax.random.PRNGKey(0))
    jq, _ = jax_quantize_tree(jp, method="squant", bits=8)
    jq = jax.device_get(jq)
    bank = jq["encoder"]["layers"]["ffn"]["wi"]["w"]
    assert tuple(bank.shape) == (2 * 256, 256)
    tq = convert.from_jax_params(jq, device="cpu")
    for layer in range(2):
        qt = tq["encoder"]["layers"][layer]["ffn"]["wi"]["w"]
        assert isinstance(qt, QuantizedTensor) and qt.shape == (256, 256)
        rows = slice(layer * 256, (layer + 1) * 256)
        np.testing.assert_array_equal(qt.data.numpy(),
                                      np.asarray(bank.data)[rows])
        np.testing.assert_array_equal(qt.scale.numpy(),
                                      np.asarray(bank.scale)[rows])
        assert tuple(tq["encoder"]["layers"][layer]["ln1"]["gain"].shape) \
            == (256,)


def test_adamw_state_of_the_encoder_unrolls_and_decays_like_reference():
    """An AdamW state of the reference's tree carries over with its encoder
    moments unrolled; the reference decays every leaf of two or more
    dimensions, so its stacked encoder's norm gains decay, whatever
    ``scan_layers`` says, and ``decay_mask`` says the same of the port's
    unrolled ones (the decoder stack's gains only when stacked)."""
    jc, _ = _cfgs(scan_layers=False)
    jp = jax_build_model(jc).init(jax.random.PRNGKey(0))
    jst = jax.device_get(jopt.adamw_init(jp))
    st = convert.from_jax_params(jst, device="cpu")
    assert len(st["m"]["encoder"]["layers"]) == 2
    assert tuple(st["v"]["encoder"]["layers"][1]["ln2"]["gain"].shape) == \
        (jc.d_model,)
    tp = convert.from_jax_params(jax.device_get(jp), device="cpu")
    for stacked in (False, True):
        mask = topt.decay_mask(tp, stacked)
        assert all(topt.tree_leaves(topt.tree_map(
            lambda m: m, mask["encoder"]["layers"])))
        assert mask["encoder"]["final_norm"]["gain"] is False
        assert mask["stack"]["list"][0]["b0"]["xln"]["gain"] is stacked
        assert mask["stack"]["list"][0]["b0"]["xattn"]["wq"]["w"] is True
