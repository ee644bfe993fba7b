"""Port vs reference: whole models with MLA (reduced ``minicpm3-4b``) and
a sliding window with MoE (reduced ``mixtral-8x7b``), float32.

The reference model is initialised with ``jax.random`` and carried across
with ``convert.from_jax_params`` (stacked and unrolled trees). The
reference's ``test_swa_ring_buffer_long_prefill`` shape (window 8, a
24-token prompt, then decode across the ring) gives logits within 2e-3 of
the reference's; ``LM.train_loss`` within ``rtol=1e-5`` and its gradients
within ``rtol=2e-4, atol=2e-5`` (the tolerances of
``tests/test_torch_train_step.py``). Mixtral's published capacity on
``chip_smoke.py`` 12c's serving traffic, at the reduced width: the
reference engine's own agreement is pinned, and the port's matches equal
it."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.model import arch_features, build_model
from repro_torch.serving.engine import ServeConfig
from repro_torch.serving.equivalence import agreement_budget
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

SWA_TOL = dict(rtol=2e-3, atol=2e-3)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
# label -> (registry arch, overrides of the reduced config)
MODELS = {"mla": ("minicpm3-4b", {}),
          "sliding_window+moe": ("mixtral-8x7b", dict(window=8))}
_PAIRS = {}


def _pair(label, scan_layers=True, **over):
    key = (label, scan_layers, tuple(sorted(over.items())))
    if key not in _PAIRS:
        name, base = MODELS[label]
        kw = dict(base, dtype="float32", remat=False, n_layers=2,
                  scan_layers=scan_layers, **over)
        jcfg = dataclasses.replace(jax_get_config(name, reduced=True), **kw)
        tcfg = dataclasses.replace(get_config(name, reduced=True), **kw)
        jm = jax_build_model(jcfg)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        _PAIRS[key] = (jm, jp, build_model(tcfg),
                       convert.from_jax_params(jax.device_get(jp),
                                               device="cpu"))
    return _PAIRS[key]


def _tokens(vocab, b, s, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, s))


@pytest.mark.parametrize("scan_layers", [True, False],
                         ids=["stacked", "unrolled"])
@pytest.mark.parametrize("label", sorted(MODELS))
def test_convert_carries_the_reference_tree(label, scan_layers):
    """A stacked and an unrolled reference tree come across leaf for leaf
    (the port's tree is always the unrolled layer list), each leaf equal
    to the reference's."""
    jm, jp, tm, tp = _pair(label, scan_layers)
    assert ("periods" in jp["stack"]) == scan_layers
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = topt.tree_map(lambda t: tuple(t.shape), own)
    assert topt.tree_map(lambda t: tuple(t.shape), tp) == shapes
    stack = jp["stack"]
    if scan_layers:
        first = jax.tree_util.tree_map(lambda a: a[1], stack["periods"])
    else:
        first = stack["list"][1]
    want = convert.from_jax_params(jax.device_get(first), device="cpu")
    got = tp["stack"]["list"][1]
    for a, b in zip(topt.tree_leaves(want), topt.tree_leaves(got)):
        assert torch.equal(a, b)
    feats = arch_features(tm.cfg)
    assert feats == (("mla",) if label == "mla"
                     else ("sliding_window", "moe"))


@pytest.mark.parametrize("label", sorted(MODELS))
def test_long_prefill_then_decode_matches_reference(label):
    """The reference's ``test_swa_ring_buffer_long_prefill``: a prompt three
    times the window, its last-token logits equal to the train-mode
    forward's, then decode steps across the ring, each step's logits
    within 2e-3 of the reference's."""
    jm, jp, tm, tp = _pair(label)
    b, s, steps = 1, 24, 6
    toks = _tokens(tm.cfg.vocab, b, s)
    jfull, _, _ = jax.jit(jm.forward, static_argnames="mode")(
        jp, {"tokens": jnp.asarray(toks)}, mode="train")
    tfull, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)},
                          mode="train")
    np.testing.assert_allclose(tfull.detach().numpy(), np.asarray(jfull),
                               **SWA_TOL)
    jc = jm.init_cache(b, s + 8)
    tc = tm.init_cache(b, s + 8, device="cpu")
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    jdecode = jax.jit(jm.decode_step)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SWA_TOL)
    np.testing.assert_allclose(tl.numpy(), tfull[:, -1].detach().numpy(),
                               **SWA_TOL)
    if tm.cfg.window:
        assert tc["list"][0]["b0"]["k"].shape[1] == tm.cfg.window
    for i in range(steps):
        tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **SWA_TOL)
    assert tc["pos"] == s + steps


@pytest.mark.parametrize("label", sorted(MODELS))
def test_train_loss_and_grads_match_reference(label):
    jm, jp, tm, tp = _pair(label)
    toks = _tokens(tm.cfg.vocab, 4, 16, seed=1)
    labels = np.roll(toks, -1, axis=1)
    batch = {"tokens": toks, "labels": labels}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tmet, tg = tloop._value_and_grad(tm.train_loss, tp,
                                         tloop.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    np.testing.assert_allclose(float(tmet["moe_aux"]),
                               float(jmet["moe_aux"]), rtol=1e-5, atol=0)
    want = convert.from_jax_params(jax.device_get(jg), device="cpu")
    lw, lt = topt.tree_leaves(want), topt.tree_leaves(tg)
    assert len(lw) == len(lt)
    for a, b in zip(lw, lt):
        assert a.shape == b.shape
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)


def test_singleton_chunk_pad_and_ring_clock():
    """A one-token chunk is padded to two rows on MLA and window stacks, as
    the reference pads every stack without MoE or recurrent state, and not
    on mixtral's MoE stack; a ring takes a chunk at a clock past its
    slots (the contiguous cache's bounds check applies to its positions,
    which a ring wraps)."""
    window = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                                 dtype="float32", n_layers=1, window=4)
    for label, want in (("mla", 2), ("sliding_window+moe", 1)):
        assert _pair(label)[2].chunk_rows(1) == want
    model = build_model(window)
    assert model.chunk_rows(1) == 2 and model.chunk_rows(3) == 3
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    cache = model.init_cache(1, 12, device="cpu")
    toks = torch.arange(1, 11)[None]
    for p in range(0, 10, 3):
        lg, cache = model.prefill_chunk(params, {"tokens": toks[:, p:p + 3]},
                                        cache)
    assert cache["pos"] == 10 and cache["list"][0]["b0"]["k"].shape[1] == 4
    assert bool(torch.isfinite(lg).all())


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


def test_swa_moe_published_capacity_reference_rate():
    """The reading ``chip_smoke.py``'s 12c gates mixtral's published
    capacity at: on 12c's traffic at the reduced width (8 slots against
    one, 64-token chunks, prompts past the window; ``swa_reference_case``)
    the reference engine's own teacher-forced matches are pinned, below
    the composed ``sliding_window x moe`` budget: a contiguous pending
    routes its slots' chunks together under one capacity where the
    one-slot oracle routes one prompt's. The port, on the same weights,
    makes the same matches request by request."""
    from repro.serving.equivalence import greedy_token_agreement as jgta
    from repro.serving.equivalence import oracle_tokens as jot
    cs = _chip_smoke()
    tm, tp, reqs, kw, one = cs.swa_reference_case()
    assert tm.cfg.moe.capacity_factor == 1.25 and tm.cfg.moe.n_experts == 8
    jc = dataclasses.replace(
        jax_get_config("mixtral-8x7b", reduced=True), n_layers=2,
        dtype="float32", window=cs.SWA_REFERENCE_WINDOW,
        moe=jax_get_config("mixtral-8x7b").moe, scan_layers=False)
    jm = jax_build_model(jc)
    jp = _to_jax(tp)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(jp) == \
        jax.tree_util.tree_structure(shapes)
    assert [a.shape for a in jax.tree_util.tree_leaves(jp)] == \
        [a.shape for a in jax.tree_util.tree_leaves(shapes)]
    jreqs = [jeng.Request(list(r.prompt), r.max_new_tokens,
                          request_id=r.request_id) for r in reqs]
    oracle = jot(jeng.ServeEngine(jm, jp, jeng.ServeConfig(**one))
                 .generate(jreqs))
    want = jgta(jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw)), jreqs,
                oracle)
    assert want.compared == 4 * cs.SWA_NEW
    assert want.matched == cs.SWA_REFERENCE_MATCHED
    assert want.rate < agreement_budget(ServeConfig(**kw), tm.cfg) == \
        pytest.approx(0.95 * 0.85)
    rep = cs.swa_reference_agreement("cpu")
    assert (rep.matched, rep.compared) == (want.matched, want.compared)
    assert rep.per_request == want.per_request
