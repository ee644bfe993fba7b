"""Port vs reference: the dense transformer. The reference model is
initialised with ``jax.random``, fetched to the host and carried across with
``convert.from_jax_params``; prefill logits and 8 decode steps must agree
within 1e-4 (float32), for dense weights and for a QuantizedTensor tree
(w8 and w4) quantized by the reference pipeline."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.models.model import build_model as jax_build_model
from repro.models.transformer import n_periods as jax_n_periods
from repro.models.transformer import unstack_stack as jax_unstack
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.model import arch_features, build_model
from repro_torch.models.transformer import (layer_plan, n_periods,
                                            unstack_stack)
from repro_torch.quant.qtypes import QuantizedTensor

# small shapes: one thread a process, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

ARCHS = ["granite-3-8b", "gemma-7b", "minitron-4b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _pair(arch, bits=None):
    jcfg = dataclasses.replace(jax_get_config(arch, reduced=True),
                               dtype="float32", scan_layers=bits is None)
    jmodel = jax_build_model(jcfg)
    jparams = jax_build_model(dataclasses.replace(
        jcfg, scan_layers=True)).init(jax.random.PRNGKey(0))
    if bits is not None:
        jparams = dict(jparams)
        jparams["stack"] = jax_unstack(jparams["stack"], jax_n_periods(jcfg))
        jparams, _ = jax_quantize_tree(jparams, method="squant", bits=bits)
    tcfg = dataclasses.replace(get_config(arch, reduced=True),
                               dtype="float32")
    tparams = convert.from_jax_params(jax.device_get(jparams), device="cpu")
    return jmodel, jparams, build_model(tcfg), tparams


def _run(jmodel, jparams, tmodel, tparams, rng, steps=8):
    b, plen, max_len = 3, 7, 32
    vocab = tmodel.cfg.vocab
    prompt = rng.integers(0, vocab, size=(b, plen))
    follow = rng.integers(0, vocab, size=(steps, b, 1))
    jc = jmodel.init_cache(b, max_len)
    tc = tmodel.init_cache(b, max_len, device="cpu")
    jl, jc = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)}, jc)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(prompt)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for t in range(steps):                       # teacher-forced: same tokens
        jl, jc = jmodel.decode_step(jparams, jnp.asarray(follow[t]), jc)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(follow[t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["pos"] == int(jc["pos"]) == plen + steps
    return tl


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_logits_match(rng, arch):
    _run(*_pair(arch), rng)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tree_logits_match(rng, arch, bits):
    jmodel, jparams, tmodel, tparams = _pair(arch, bits)
    wq = tparams["stack"]["list"][0]["b0"]["attn"]["wq"]["w"]
    assert isinstance(wq, QuantizedTensor) and wq.bits == bits
    assert wq.data.shape[1] == (wq.shape[1] // 2 if bits <= 4 else wq.shape[1])
    _run(jmodel, jparams, tmodel, tparams, rng)


def test_full_forward_all_positions(rng):
    jmodel, jparams, tmodel, tparams = _pair("granite-3-8b")
    toks = rng.integers(0, 256, size=(2, 9))
    jl, _, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                              mode="train")
    tl, caches = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)},
                                mode="train")
    assert caches is None
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


def test_configs_are_equal_copies():
    """The dense GQA configs: equal to the reference's, plain-attention
    dense plans (all ten configs are held field by field in
    ``tests/test_torch_configs.py``)."""
    assert set(ARCHS) <= set(list_archs())
    for arch in ARCHS:
        for red in (False, True):
            a = dataclasses.asdict(jax_get_config(arch, reduced=red))
            b = dataclasses.asdict(get_config(arch, reduced=red))
            assert a == b
        cfg = get_config(arch)
        assert arch_features(cfg) == ()
        assert layer_plan(cfg) == (("a", False),)
        assert n_periods(cfg) == cfg.n_layers


def test_own_init_shapes_dtypes_std():
    cfg = get_config("minitron-4b", reduced=True)        # bfloat16, untied
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    jp = jax_build_model(dataclasses.replace(
        jax_get_config("minitron-4b", reduced=True), scan_layers=False)
    ).init(jax.random.PRNGKey(0))

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in sorted(t.items())}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))
    assert shapes(p) == shapes(jax.device_get(jp))
    w = p["stack"]["list"][0]["b0"]["ffn"]["wi"]["w"]
    assert abs(float(w.std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(p["embedding"]["embedding"].float().std()) - 0.02) < 0.004
    q = model.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(q["lm_head"]["w"], p["lm_head"]["w"])


def test_convert_bf16_and_unstack():
    import ml_dtypes
    a = np.arange(12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16)
    t = convert.from_jax_params({"x": a, "stack": {"periods": {
        "b0": {"w": np.arange(24, dtype=np.float32).reshape(2, 3, 4)}}}},
        device="cpu")
    assert t["x"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["x"].float().numpy(),
                                  a.astype(np.float32))
    assert [tuple(l["b0"]["w"].shape) for l in t["stack"]["list"]] == \
        [(3, 4), (3, 4)]
    st = unstack_stack({"periods": {"w": torch.arange(6).reshape(2, 3)}}, 2)
    assert torch.equal(st["list"][1]["w"], torch.tensor([3, 4, 5]))


def test_convert_defaults_to_the_cuda_device():
    """With no device given the tree goes to the current CUDA device, as
    every entry point of the port does; without one the call raises and
    never quietly returns host tensors."""
    tree = {"w": np.ones((2, 3), dtype=np.float32)}
    if torch.cuda.is_available():
        assert convert.from_jax_params(tree)["w"].is_cuda
        return
    with pytest.raises((AssertionError, RuntimeError)):
        convert.from_jax_params(tree)


def test_rope_and_masks_match(rng):
    from repro.models.attention import causal_mask as jmask
    from repro.models.layers import apply_rotary as jrot
    from repro.models.transformer import rope_values as jrope
    pos = np.array([[0, 3, 9], [5, 6, 7]])
    for p in (pos[0], pos):
        jc, js = jrope(jnp.asarray(p), 16, 10000.0)
        tc, ts = layers.rope(torch.from_numpy(p), 16, 10000.0)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=1e-6)
        x = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
        np.testing.assert_allclose(
            layers.apply_rotary(torch.from_numpy(x), tc, ts).numpy(),
            np.asarray(jrot(jnp.asarray(x), jc, js)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(attn.causal_mask(3, 5).numpy(),
                                  np.asarray(jmask(3, 5)))
    assert attn.NEG_INF == -2.0 ** 30


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu"])
def test_ffn_kinds_match(rng, kind):
    from repro.models.ffn import ffn as jffn
    from repro_torch.models.ffn import ffn as tffn
    names = ("wi", "wg", "wdown") if kind in ("swiglu", "geglu") \
        else ("wi", "wdown")
    p = {n: {"w": rng.normal(size=(32, 8) if n == "wdown" else (8, 32))
             .astype(np.float32)} for n in names}
    x = rng.normal(size=(2, 5, 8)).astype(np.float32)
    want = jffn(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x), kind)
    got = tffn(convert.from_jax_params(p, device="cpu"), torch.from_numpy(x),
               kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("what", ["mla", "window", "chunk", "verify", "paged",
                                  "per_row_pos", "quant_kv"])
def test_later_slices_raise_by_name(what):
    """What a later slice ports raises ``NotImplementedError`` naming
    itself; what has been ported since (the ``chunk`` mode, paged decode
    through block tables, int8 KV caches, the speculative ``verify`` mode,
    per-row decode positions on a contiguous cache) runs instead."""
    cfg = get_config("granite-3-8b", reduced=True)
    kw = dict(cfg=cfg, rope=None, mode="decode", cache={}, pos=0)
    if what == "verify":
        # two slots, three positions each, written through the tables
        cfg = dataclasses.replace(cfg, dtype="float32")
        p = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        hd, kvh = cfg.head_dim, cfg.n_kv_heads
        x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1))
        pos = torch.tensor([3, 5], dtype=torch.int32)
        cache = attn.init_kv_cache(5, 4, kvh, hd, torch.float32,
                                   device="cpu")
        bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        rows = pos[:, None] + torch.arange(3)
        out, cache = attn.attention(p, x, cfg=cfg, mode="verify",
                                    rope=layers.rope(rows, hd,
                                                     cfg.rope_theta),
                                    cache=cache, pos=pos, block_tables=bt)
        assert out.shape == x.shape and torch.isfinite(out).all()
        assert cache["k"][2, 1:].abs().sum() > 0     # slot 0: 5, 6 (block 2)
        assert cache["k"][4, :].abs().sum() > 0      # slot 1: 5..7 (block 3+)
        return
    if what == "per_row_pos":
        model = build_model(dataclasses.replace(cfg, dtype="float32"))
        p = model.init(torch.Generator().manual_seed(0), device="cpu")
        c = model.init_cache(2, 8, device="cpu")
        c["pos"] = torch.tensor([1, 2])
        lg, c2 = model.decode_step(p, torch.zeros(2, 1, dtype=torch.long), c)
        assert lg.shape == (2, cfg.vocab) and torch.isfinite(lg).all()
        k = c["list"][0]["b0"]["k"]
        assert k[0, 1].abs().sum() > 0 and k[1, 2].abs().sum() > 0
        assert k[0, 2].abs().sum() == 0 and k[1, 1].abs().sum() == 0
        assert torch.equal(c2["pos"], torch.tensor([2, 3]))
        return
    if what in ("chunk", "paged", "quant_kv"):
        cfg = dataclasses.replace(cfg, dtype="float32")
        p = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                                device="cpu")
        hd, kvh = cfg.head_dim, cfg.n_kv_heads
        x = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                        .manual_seed(1))
        pos = torch.tensor([3, 5], dtype=torch.int32)
        if what == "paged":
            cache = attn.init_kv_cache(5, 4, kvh, hd, torch.float32,
                                       device="cpu")
            bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
            out, _ = attn.attention(p, x, cfg=cfg, mode="decode",
                                    rope=layers.rope(pos[:, None], hd,
                                                     cfg.rope_theta),
                                    cache=cache, pos=pos, block_tables=bt)
        else:
            cache = attn.init_kv_cache(2, 8, kvh, hd, torch.float32,
                                       quantize=what == "quant_kv",
                                       device="cpu")
            out, cache = attn.attention(
                p, x, cfg=cfg, mode=what if what == "chunk" else "decode",
                rope=layers.rope(torch.tensor([3]), hd, cfg.rope_theta),
                cache=cache, pos=3)
            assert (cache["k_scale"][:, 3] > 0).all() \
                if what == "quant_kv" else cache["k"][:, 3].abs().sum() > 0
        assert out.shape == x.shape and torch.isfinite(out).all()
        return
    if what == "mla":
        from repro_torch.configs.base import MLAConfig
        kw["cfg"] = dataclasses.replace(cfg, mla=MLAConfig())
    elif what == "window":
        kw["cfg"] = dataclasses.replace(cfg, window=8)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        attn.attention({}, torch.zeros(1, 1, cfg.d_model), **kw)
