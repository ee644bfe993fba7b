"""Port vs reference: multi-head latent attention (``models/attention.py``
``init_attention``'s MLA branch, ``_mla_attention``,
``_mla_absorbed_decode``, ``init_mla_cache``) on the reduced
``minicpm3-4b`` (float32). The reference attention is initialised with
``jax.random`` and carried across with ``convert.from_jax_params``; the
same numpy activations go through both. Outputs and the compressed cache
agree within 1e-5 through prefill, chunk continuations and decode steps,
and through the weight-absorbed decode on an fp and a quantized
``kv_up``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.models import attention as jattn
from repro.models.transformer import rope_values as jax_rope
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models.transformer import rope_values
from repro_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, MAX_LEN = 2, 24
ARCH = "minicpm3-4b"

_jax_attention = jax.jit(jattn.attention, static_argnames=("cfg", "mode"))


def _cfgs(absorb=False):
    jc = dataclasses.replace(jax_get_config(ARCH, reduced=True),
                             dtype="float32")
    tc = dataclasses.replace(get_config(ARCH, reduced=True), dtype="float32")
    return (dataclasses.replace(jc, mla=dataclasses.replace(
        jc.mla, absorb=absorb)),
            dataclasses.replace(tc, mla=dataclasses.replace(
                tc.mla, absorb=absorb)))


def _params(jcfg, quantized=False):
    jp = jattn.init_attention(jax.random.PRNGKey(0), jcfg)
    if quantized:
        jp, _ = jax_quantize_tree(jp, method="squant", bits=8)
    return jp, convert.from_jax_params(jax.device_get(jp), device="cpu")


def _shapes(tree):
    return {k: tuple(v.shape) for k, v in tree.items()} \
        if not isinstance(next(iter(tree.values())), dict) else \
        {k: _shapes(v) for k, v in tree.items()}


def test_mla_init_leaf_names_and_shapes_equal_reference():
    for reduced in (True, False):
        jcfg = jax_get_config(ARCH, reduced=reduced)
        tcfg = get_config(ARCH, reduced=reduced)
        want = jax.eval_shape(lambda: jattn.init_attention(
            jax.random.PRNGKey(0), jcfg))
        got = attn.init_attention(torch.Generator().manual_seed(0), tcfg,
                                  device="meta")
        assert sorted(got) == sorted(want)
        assert _shapes(got) == _shapes(want)


def test_init_mla_cache_equals_reference():
    jcfg, tcfg = _cfgs()
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        want = jattn.init_mla_cache(3, 17, jcfg, dt)
        got = attn.init_mla_cache(3, 17, tcfg, tdt, device="cpu")
        assert _shapes(got) == _shapes(want)
        assert all(v.dtype == tdt and not v.any() for v in got.values())


def _close_cache(jc, tc):
    assert sorted(jc) == sorted(tc) == ["c_kv", "k_rope"]
    for name in jc:
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   err_msg=name, **TOL)


def _call(jcfg, tcfg, jp, tp, x, mode, jc, tc, pos):
    """One attention call of both packages at positions ``pos ..``."""
    positions = np.arange(pos, pos + x.shape[1])
    rd = tcfg.mla.rope_dim
    jo, jc = _jax_attention(
        jp, jnp.asarray(x), cfg=jcfg, mode=mode, cache=jc, pos=jnp.int32(pos),
        rope=jax_rope(jnp.asarray(positions), rd, jcfg.rope_theta))
    to, tc = attn.attention(
        tp, torch.from_numpy(x), cfg=tcfg, mode=mode, cache=tc, pos=pos,
        rope=rope_values(torch.from_numpy(positions), rd, tcfg.rope_theta))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_cache(jc, tc)
    return jc, tc


# the prompt as one prefill, or as chunk continuations (the last one a
# singleton), then decode steps over the re-expanded cache
PATHS = {"prefill": ("prefill", (7,)), "chunks": ("chunk", (3, 3, 1))}


@pytest.mark.parametrize("absorb", [False, True], ids=["expand", "absorb"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_mla_prefill_chunk_decode_match(rng, path, quantized, absorb):
    """Each call's output and the ``c_kv``/``k_rope`` cache within 1e-5;
    ``absorb`` takes ``_mla_absorbed_decode`` at decode (a quantized
    ``kv_up`` dequantized and transposed there, as the reference does)."""
    jcfg, tcfg = _cfgs(absorb)
    jp, tp = _params(jcfg, quantized)
    assert isinstance(tp["kv_up"]["w"], QuantizedTensor) == quantized
    mode, chunks = PATHS[path]
    steps = 5
    x = rng.normal(size=(B, sum(chunks) + steps, tcfg.d_model)
                   ).astype(np.float32)
    jc = jattn.init_mla_cache(B, MAX_LEN, jcfg, jnp.float32)
    tc = attn.init_mla_cache(B, MAX_LEN, tcfg, torch.float32, device="cpu")
    pos = 0
    for n in chunks:
        jc, tc = _call(jcfg, tcfg, jp, tp, x[:, pos:pos + n], mode, jc, tc,
                       pos)
        pos += n
    for _ in range(steps):
        jc, tc = _call(jcfg, tcfg, jp, tp, x[:, pos:pos + 1], "decode", jc,
                       tc, pos)
        pos += 1


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "w8"])
def test_mla_absorbed_decode_matches_reference(rng, quantized):
    """The function itself on the same inputs: query, a half-filled latent
    cache and its mask."""
    jcfg, tcfg = _cfgs(absorb=True)
    jp, tp = _params(jcfg, quantized)
    m, h = tcfg.mla, tcfg.n_heads
    qfull = rng.normal(size=(B, 1, h, m.nope_dim + m.rope_dim)
                       ).astype(np.float32)
    ckv = rng.normal(size=(B, MAX_LEN, m.kv_lora)).astype(np.float32)
    krope = rng.normal(size=(B, MAX_LEN, 1, m.rope_dim)).astype(np.float32)
    pos = 9
    ckv[:, pos + 1:] = 0
    krope[:, pos + 1:] = 0
    jmask = jnp.where(jnp.arange(MAX_LEN) <= pos, 0.0,
                      jattn.NEG_INF)[None, None, None, None, :]
    tmask = torch.from_numpy(np.array(jmask))
    scale = (m.nope_dim + m.rope_dim) ** -0.5
    want = jattn._mla_absorbed_decode(jp, jnp.asarray(qfull),
                                      jnp.asarray(ckv), jnp.asarray(krope),
                                      jmask, scale, jcfg.mla, h)
    got = attn._mla_absorbed_decode(tp, torch.from_numpy(qfull),
                                    torch.from_numpy(ckv),
                                    torch.from_numpy(krope), tmask, scale,
                                    tcfg.mla, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_mla_train_mode_matches_reference(rng):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    x = rng.normal(size=(B, 9, tcfg.d_model)).astype(np.float32)
    positions = np.arange(9)
    rd = tcfg.mla.rope_dim
    jo, _ = jattn.attention(jp, jnp.asarray(x), cfg=jcfg, mode="train",
                            rope=jax_rope(jnp.asarray(positions), rd,
                                          jcfg.rope_theta))
    to, _ = attn.attention(tp, torch.from_numpy(x), cfg=tcfg, mode="train",
                           rope=rope_values(torch.from_numpy(positions), rd,
                                            tcfg.rope_theta))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)


def test_mla_gates_name_themselves():
    _, tcfg = _cfgs()
    x = torch.zeros(2, 1, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="'verify' mode is not "
                       "implemented for MLA attention"):
        attn.attention({}, x, cfg=tcfg, rope=None, mode="verify", cache={},
                       pos=torch.tensor([0, 0]))
    tp = attn.init_attention(torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    cache = attn.init_mla_cache(2, 8, tcfg, torch.float32, device="cpu")
    pos = torch.tensor([1, 2])
    with pytest.raises(NotImplementedError, match="per-row decode positions"):
        attn.attention(tp, x, cfg=tcfg, rope=rope_values(
            pos[:, None], tcfg.mla.rope_dim, tcfg.rope_theta),
            mode="decode", cache=cache, pos=pos)
    with pytest.raises(ValueError, match="exceeds the cache length"):
        attn.attention(tp, torch.zeros(2, 3, tcfg.d_model), cfg=tcfg,
                       rope=rope_values(torch.arange(6, 9),
                                        tcfg.mla.rope_dim, tcfg.rope_theta),
                       mode="chunk", cache=cache, pos=6)
