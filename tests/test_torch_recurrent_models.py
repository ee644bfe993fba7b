"""Port vs reference: whole models with recurrent mixers, float32 — reduced
``jamba-1.5-large-398b`` (its full 8-layer period: seven mamba layers, one
attention layer, MoE on every other layer) and reduced ``rwkv6-1.6b``.

The reference model is initialised with ``jax.random`` and carried across
with ``convert.from_jax_params``. Logits agree within 1e-4 in prefill, in
chunk splits of a prompt and in decode; ``LM.train_loss`` within
``rtol=1e-5`` and its gradients within ``rtol=2e-4, atol=2e-5``;
``quantize_tree``'s codes are bit-identical and its scales equal at a width
with grouped buckets and rwkv's whole-row ``w_lora_b`` bucket. Serving: a
request admitted after another retires gets the tokens a fresh engine
gives, on a side cache allocated afresh; verify mode raises on a recurrent
block, as in the reference."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.configs import get_config as jax_get_config
from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jeng
from repro.serving.equivalence import greedy_token_agreement as jgta
from repro.serving.equivalence import oracle_tokens as jot
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.pipeline import quantize_tree
from repro_torch.models.model import arch_features, build_model
from repro_torch.quant.qtypes import QuantizedTensor
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.equivalence import agreement_budget
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
MODELS = {"mamba": "jamba-1.5-large-398b", "rwkv": "rwkv6-1.6b"}
_PAIRS = {}


def _pair(label, **over):
    key = (label, tuple(sorted(over.items())))
    if key not in _PAIRS:
        kw = dict(dtype="float32", remat=False, **over)
        jc = dataclasses.replace(jax_get_config(MODELS[label], reduced=True),
                                 **kw)
        tc = dataclasses.replace(get_config(MODELS[label], reduced=True),
                                 **kw)
        jm = jax_build_model(jc)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        _PAIRS[key] = (jm, jp, build_model(tc),
                       convert.from_jax_params(jax.device_get(jp),
                                               device="cpu"))
    return _PAIRS[key]


def _tokens(vocab, b, s, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("label", sorted(MODELS))
def test_convert_carries_the_reference_tree(label):
    """The reference's tree (rwkv's stacked over its four layers, jamba's
    one period unrolled) comes across leaf for leaf, in the shapes of the
    port's own init, with the reference's keys (``mu`` dicts, ``u``,
    ``w0``, ``ln_x``, ``a_log``, ``conv_w``, ``conv_b``, ``dt_bias``,
    ``d_skip``)."""
    jm, jp, tm, tp = _pair(label)
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert topt.tree_map(lambda t: tuple(t.shape), tp) == \
        topt.tree_map(lambda t: tuple(t.shape), own)
    block = tp["stack"]["list"][0]["b0"]
    if label == "rwkv":
        assert "periods" in jp["stack"]
        assert set(block["tm"]) == {"ln_x", "mu", "u", "w0", "wg", "wk",
                                    "w_lora_a", "w_lora_b", "wo", "wr", "wv"}
        assert set(block["cm"]) == {"mu", "wk", "wv", "wr"}
        want = np.asarray(jp["stack"]["periods"]["b0"]["tm"]["u"][2])
        got = tp["stack"]["list"][2]["b0"]["tm"]["u"].numpy()
    else:
        assert len(tp["stack"]["list"]) == 1
        assert set(block["mixer"]) == {"in_proj", "conv_w", "conv_b",
                                       "x_proj", "dt_proj", "dt_bias",
                                       "a_log", "d_skip", "out_proj"}
        assert "moe" in tp["stack"]["list"][0]["b1"]
        want = np.asarray(jp["stack"]["list"][0]["b5"]["mixer"]["dt_bias"])
        got = tp["stack"]["list"][0]["b5"]["mixer"]["dt_bias"].numpy()
    assert np.array_equal(got, want)
    assert arch_features(tm.cfg) == (("moe", "mamba") if label == "mamba"
                                     else ("rwkv",))


@pytest.mark.parametrize("label", sorted(MODELS))
def test_prefill_chunks_and_decode_match_reference(label):
    """A prefill of 32 tokens (and the train-mode forward over them), the
    same prompt in chunk splits 11 + 16 + 5 from a fresh cache (on rwkv
    equal to the prefill's logits too), then six greedy decode steps:
    logits within 1e-4 of the reference's at every step, the recurrent
    state carried across, in the reference's dtypes."""
    jm, jp, tm, tp = _pair(label)
    b, s = 2, 32
    toks = _tokens(tm.cfg.vocab, b, s)
    jfull, _, _ = jax.jit(jm.forward, static_argnames="mode")(
        jp, {"tokens": jnp.asarray(toks)}, mode="train")
    tfull, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                          mode="train")
    np.testing.assert_allclose(tfull.detach().numpy(), np.asarray(jfull),
                               **TOL)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)},
                                 jm.init_cache(b, s + 8))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)},
                        tm.init_cache(b, s + 8, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jcc, tcc = jm.init_cache(b, s + 8), tm.init_cache(b, s + 8, device="cpu")
    for lo, hi in ((0, 11), (11, 27), (27, 32)):
        jcl, jcc = jm.prefill_chunk(jp, {"tokens": jnp.asarray(
            toks[:, lo:hi])}, jcc)
        tcl, tcc = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(
            toks[:, lo:hi])}, tcc)
        np.testing.assert_allclose(tcl.numpy(), np.asarray(jcl), **TOL)
    if "moe" not in arch_features(tm.cfg):
        # MoE capacity routes per chunk (the "moe" budget); the recurrence
        # alone carries across chunks up to float reassociation
        np.testing.assert_allclose(tcl.numpy(), tl.numpy(), **TOL)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(6):
        tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["pos"] == s + 6
    # the carried state, layer by layer (the reference's stacked cache
    # unrolled)
    jlist = jc["list"] if "list" in jc else [
        jax.tree_util.tree_map(lambda a: a[i], jc["periods"])
        for i in range(len(tc["list"]))]
    assert len(jlist) == len(tc["list"])
    for jper, tper in zip(jlist, tc["list"]):
        for blk in jper:
            if "mixer" not in tp["stack"]["list"][0][blk] and \
                    "tm" not in tp["stack"]["list"][0][blk]:
                continue                        # attention: K/V rows
            for k in jper[blk]:
                assert str(tper[blk][k].dtype).replace("torch.", "") == \
                    str(jper[blk][k].dtype)
                np.testing.assert_allclose(tper[blk][k].numpy(),
                                           np.asarray(jper[blk][k]), **TOL)


@pytest.mark.parametrize("label", sorted(MODELS))
def test_train_loss_and_grads_match_reference(label):
    jm, jp, tm, tp = _pair(label)
    toks = _tokens(tm.cfg.vocab, 2, 32, seed=1)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet, tg = tloop._value_and_grad(tm.train_loss, tp,
                                         tloop.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    want = convert.from_jax_params(jax.device_get(jg), device="cpu")
    lw, lt = topt.tree_leaves(want), topt.tree_leaves(tg)
    assert len(lw) == len(lt)
    for a, b in zip(lw, lt):
        assert a.shape == b.shape
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def _qleaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _qleaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _qleaves(v, path + (str(i),))
    elif hasattr(tree, "scale"):
        yield path, tree


@pytest.mark.parametrize("label", sorted(MODELS))
def test_quantize_tree_codes_bit_identical_to_reference(label):
    """SQuant w8 at d_model 256 (grouped g128 buckets beside whole-row
    ones: rwkv's ``w_lora_b`` (64 -> 256) and mamba's ``dt_proj``, whose
    input is shorter than a group): codes bit-identical and scales equal,
    leaf by leaf; the decay lerp (``mu["d"]``), ``u``, ``w0`` and mamba's
    conv and SSM parameters are left as they are."""
    over = dict(d_model=256, d_ff=256, n_layers=2 if label == "rwkv" else 8,
                scan_layers=False)
    if label == "rwkv":
        over["rwkv_head_dim"] = 64
    jm, jp, tm, tp = _pair(label, **over)
    jq, jrep = jax_quantize_tree(jp, method="squant", bits=8)
    tq, trep = quantize_tree(tp, method="squant", bits=8, device="cpu")
    jl = dict(_qleaves(jax.device_get(jq)))
    tl = dict(_qleaves(tq))
    assert sorted(jl) == sorted(tl)
    for path, a in jl.items():
        b = tl[path]
        assert isinstance(b, QuantizedTensor)
        assert np.array_equal(b.data.numpy(), np.asarray(a.data)), path
        assert np.array_equal(b.scale.numpy(), np.asarray(a.scale)), path
    groups = {(lr.path.split("/")[-2], lr.bucket.split()[-1])
              for lr in trep.layers}
    if label == "rwkv":
        assert ("w_lora_b", "gNone") in groups
        assert ("w_lora_a", "g128") in groups
        assert not any(p[-1] in ("d", "u", "w0") for p in tl)
    else:
        assert ("dt_proj", "gNone") in groups and ("in_proj", "g128") in groups
        assert not any(p[-1] in ("conv_w", "a_log") for p in tl)
    assert {b.key for b in trep.buckets} == {b.key for b in jrep.buckets}


def test_has_recurrent_state_matches_reference_for_every_architecture():
    for name in jcfgs.list_archs():
        jc, tc = jcfgs.get_config(name), get_config(name)
        want = jax_build_model(jc).has_recurrent_state()
        assert build_model(tc).has_recurrent_state() == want
        assert want == (name in MODELS.values())


@pytest.mark.parametrize("label", sorted(MODELS))
def test_admission_after_a_retirement_gets_a_fresh_engines_tokens(label):
    """One slot, chunked admission: the second request is admitted after
    the first retires and gets the tokens a fresh engine gives it alone
    (and the reference engine's); each admission's side cache is a new
    allocation for a recurrent stack."""
    jm, jp, tm, tp = _pair(label)
    first = Request([7, 3, 9, 11, 2, 5, 8, 1, 4], 3, request_id=0)
    second = Request([12, 6, 2, 9, 30, 41, 5], 6, request_id=1)
    kw = dict(max_batch=1, max_len=32, scheduler="continuous",
              prefill_chunk=4)
    eng = ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")
    kv = eng.scheduler.kv
    a, b = kv.side_cache(1), kv.side_cache(1)
    ptrs = {t.data_ptr() for c in (a, b) for t in topt.tree_leaves(
        c["list"])}
    assert len(ptrs) == 2 * len(topt.tree_leaves(a["list"]))
    both = {c.request_id: c.tokens for c in eng.generate([first, second])}
    eng.close()
    fresh = ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")
    alone = fresh.generate([second])[0].tokens
    fresh.close()
    assert both[1] == alone
    jreqs = [jeng.Request(list(r.prompt), r.max_new_tokens,
                          request_id=r.request_id) for r in (first, second)]
    want = {c.request_id: [int(t) for t in c.tokens] for c in
            jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw)).generate(jreqs)}
    assert {k: [int(t) for t in v] for k, v in both.items()} == want


@pytest.mark.parametrize("label", sorted(MODELS))
def test_verify_mode_raises_on_recurrent_blocks(label):
    _, _, tm, tp = _pair(label)
    caches = tm.init_cache(1, 16, device="cpu")
    caches["pos"] = torch.zeros((1,), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="'verify' mode is not "
                       "implemented for '(m|rwkv)' blocks"):
        tm.verify_step(tp, torch.ones((1, 2), dtype=torch.int64), caches)


def _chip_smoke():
    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_jax(tree):
    """The port's unrolled float32 tree as the reference's (its layout
    with ``scan_layers=False``)."""
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("label", sorted(MODELS))
def test_recurrent_agreement_reference_rate(label):
    """The reading beside which ``chip_smoke.py``'s 13c gates: on 13c's
    traffic at the reduced width (``recurrent_reference_case``: 8 slots
    against one, 64-token chunks, prompts of one length) the reference
    engine's own teacher-forced matches are pinned, at or above the
    architecture's budget, and the port on the same weights makes the same
    matches request by request."""
    cs = _chip_smoke()
    arch = MODELS[label]
    tm, tp, reqs, kw, one = cs.recurrent_reference_case(arch)
    jc = dataclasses.replace(jax_get_config(arch, reduced=True),
                             **cs.RECURRENT_ISOLATED[arch],
                             dtype="float32", scan_layers=False)
    jm = jax_build_model(jc)
    jp = _to_jax(tp)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(shapes)
    jreqs = [jeng.Request(list(r.prompt), r.max_new_tokens,
                          request_id=r.request_id) for r in reqs]
    oracle = jot(jeng.ServeEngine(jm, jp, jeng.ServeConfig(**one))
                 .generate(jreqs))
    want = jgta(jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw)), jreqs,
                oracle)
    assert want.compared == len(reqs) * cs.RECURRENT_NEW
    assert want.matched == cs.RECURRENT_REFERENCE_MATCHED[arch]
    assert want.rate >= agreement_budget(ServeConfig(**kw), tm.cfg) == \
        pytest.approx(0.95)
    rep = cs.recurrent_reference_agreement("cpu", arch)
    assert (rep.matched, rep.compared) == (want.matched, want.compared)
    assert rep.per_request == want.per_request
