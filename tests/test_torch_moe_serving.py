"""Port vs reference: serving a mixture-of-experts stack (reduced
``moonshot-v1-16b-a3b``: plain attention, every FFN an MoE) on the
continuous scheduler, contiguous and paged, monolithic and chunked
admission, fp and SQuant w8; speculative decoding on it; a native w8
checkpoint of it; and ``chameleon-34b`` (dense with qk-norm, untied head)
on the paged path.

Greedy tokens equal the reference engine's on the same converted weights;
chunked admission is held to the reference's ``moe`` agreement budget
against the monolithic oracle; speculative tokens equal verifier-only
decode."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.quant import apply as japply
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import MoEConfig, get_config
from repro_torch.models.model import build_model
from repro_torch.serving import WeightStore
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.equivalence import (AGREEMENT_BUDGETS,
                                             agreement_budget,
                                             greedy_token_agreement,
                                             oracle_tokens)

torch.set_num_threads(1)

MOE = "moonshot-v1-16b-a3b"
# label -> overrides of the reduced config (E=4 top-2; E=8 top-6 is the
# full model's top-k over a reduced bank; E=64 top-6 the full model's
# routing)
VARIANTS = {"e4k2": {}, "e8k6": {"moe": (8, 6)}, "e64k6": {"moe": (64, 6)}}
SERVED = ["e4k2", "e8k6"]
_PAIRS = {}


def _pair(name=MOE, variant="e4k2", **over):
    """(reference model, reference params, port model, port params)."""
    key = (name, variant, tuple(sorted(over.items())))
    if key not in _PAIRS:
        dims = dict(dtype="float32", n_layers=2, **over)
        moe = VARIANTS.get(variant, {}).get("moe")
        jc = dataclasses.replace(jax_get_config(name, reduced=True), **dims)
        tc = dataclasses.replace(get_config(name, reduced=True), **dims)
        if moe is not None:
            jc = dataclasses.replace(jc, moe=dataclasses.replace(
                jc.moe, n_experts=moe[0], top_k=moe[1]))
            tc = dataclasses.replace(tc, moe=MoEConfig(
                n_experts=moe[0], top_k=moe[1]))
        jm, tm = jax_build_model(jc), build_model(tc)
        jp = jm.init(jax.random.PRNGKey(0))
        _PAIRS[key] = (jm, jp, tm, convert.from_jax_params(
            jax.device_get(jp), device="cpu"))
    return _PAIRS[key]


def _reqs():
    return [Request([1, 2, 3, 4, 5, 6], 8, request_id=0),
            Request([7, 8], 3, request_id=1),
            Request([9, 10, 11], 5, request_id=2),
            Request([4, 4, 4, 4], 6, request_id=3),
            Request([9, 8, 7, 6, 5, 4, 3, 2, 1], 4, request_id=4)]


def _eng(model, params, **kw):
    return ServeEngine(model, params, ServeConfig(**kw), device="cpu")


def _jax_tokens(jm, jp, reqs, **kw):
    out = jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw)).generate(
        [jeng.Request(list(r.prompt), r.max_new_tokens,
                      request_id=r.request_id) for r in reqs])
    return [[int(t) for t in c.tokens] for c in out]


BASE = dict(max_len=32, scheduler="continuous", max_slots=2, block_size=4,
            weight_bits=8, dequantize_for_compute=False)
CONFIGS = [dict(kv_backend=kv, prefill_chunk=c)
           for kv in ("contiguous", "paged") for c in (0, 3, 16)]


@pytest.mark.parametrize("variant", SERVED)
@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_moe_tokens_identical_to_reference(variant, cfg):
    jm, jp, tm, tp = _pair(variant=variant)
    reqs = _reqs()
    kw = dict(BASE, **cfg)
    want = _jax_tokens(jm, jp, reqs, **kw)
    eng = _eng(tm, tp, **kw)
    assert [c.tokens for c in eng.generate(reqs)] == want
    st = eng.stats()["scheduler"]
    assert st["admitted"] == st["retired"] == len(reqs)
    if cfg["kv_backend"] == "paged":
        eng.scheduler.kv.check_invariants()


@pytest.mark.parametrize("kv,chunk", [("paged", 0), ("paged", 16),
                                      ("contiguous", 3)])
def test_moe_squant_w8_tokens_identical_to_reference(kv, chunk):
    """Each engine quantizes its own tree (expert banks included; the
    router stays fp) and serves it real-quantized."""
    jm, jp, tm, tp = _pair(variant="e8k6")
    reqs = _reqs()
    kw = dict(BASE, kv_backend=kv, prefill_chunk=chunk,
              quantize_weights="squant")
    want = _jax_tokens(jm, jp, reqs, **kw)
    eng = _eng(tm, tp, **kw)
    assert [c.tokens for c in eng.generate(reqs)] == want
    moe = eng.params["stack"]["list"][0]["b0"]["moe"]
    assert type(moe["wi"]["w"]).__name__ == "QuantizedTensor"
    assert isinstance(moe["router"]["w"], torch.Tensor)


def test_moe_single_token_chunks_are_not_padded():
    """A one-token admission chunk of an MoE stack writes one row (a dummy
    row would compete for expert capacity)."""
    _, _, tm, _ = _pair()
    assert tm.chunk_rows(1) == 1 and tm.chunk_rows(5) == 5


def _wave():
    """``tests/test_chunked_archs.py``'s admission wave."""
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(4):
        plen = int(rng.integers(5, 10))
        prompt = [int(t) for t in rng.integers(1, 200, size=plen)]
        reqs.append(Request(prompt, 8, request_id=i))
    return reqs


# the reference engine's own rates in the sweep below at E=64 top-6 (the
# "moe" floor, 0.85, was set at E=4 top-2: with capacity ceil(t*6*1.25/64)
# a chunk of 1 or 3 tokens routes without the drops the monolithic
# admission makes)
FINE_GRAINED_REFERENCE_RATES = {1: 0.75, 3: 0.8125, 16: 1.0}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_moe_chunked_agreement_within_budget(variant, chunk):
    """The reference's sweep (``tests/test_chunked_archs.py``): chunked
    admission (capacity routing per chunk) against the monolithic oracle on
    the same four slots, teacher-forced. The port's matches equal the
    reference engine's own on the same weights; at or above the ``moe``
    floor for E=4 top-2 and E=8 top-6; at E=64 top-6 the reference's own
    rates (``FINE_GRAINED_REFERENCE_RATES``), two of them below the
    floor."""
    from repro.serving.equivalence import greedy_token_agreement as jgta
    from repro.serving.equivalence import oracle_tokens as jot
    jm, jp, tm, tp = _pair(variant=variant)
    reqs = _wave()
    jreqs = [jeng.Request(list(r.prompt), r.max_new_tokens,
                          request_id=r.request_id) for r in reqs]
    base = dict(max_batch=4, max_len=48, scheduler="continuous")
    oracle = oracle_tokens(_eng(tm, tp, **base).generate(reqs))
    assert oracle == jot(jeng.ServeEngine(jm, jp, jeng.ServeConfig(
        **base)).generate(jreqs))
    eng = _eng(tm, tp, prefill_chunk=chunk, **base)
    budget = agreement_budget(eng.cfg, tm.cfg)
    assert budget == AGREEMENT_BUDGETS["moe"] == 0.85
    rep = greedy_token_agreement(eng, reqs, oracle)
    want = jgta(jeng.ServeEngine(jm, jp, jeng.ServeConfig(
        prefill_chunk=chunk, **base)), jreqs, oracle)
    assert rep.compared == want.compared == 32
    assert rep.matched == want.matched
    if variant == "e64k6":
        assert want.rate == FINE_GRAINED_REFERENCE_RATES[chunk]
    else:
        rep.assert_budget(budget, f"moe {variant} chunk={chunk}")


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_moe_paged_chunked_equals_one_slot_contiguous_chunked(chunk):
    """The paged pool, chunked, against the one-slot contiguous engine with
    the same chunk width: each prompt is cut into the same chunks, so each
    chunk routes the same tokens with the same capacity, and the tokens are
    equal (a multi-slot contiguous pool attends its left padding)."""
    _, _, tm, tp = _pair(variant="e8k6")
    reqs = _wave() + _reqs()
    paged = _eng(tm, tp, max_len=48, scheduler="continuous", max_slots=3,
                 kv_backend="paged", block_size=4,
                 prefill_chunk=chunk).generate(reqs)
    solo = _eng(tm, tp, max_len=48, scheduler="continuous", max_slots=1,
                prefill_chunk=chunk).generate(reqs)
    assert [c.tokens for c in paged] == [c.tokens for c in solo]


@pytest.mark.parametrize("variant", SERVED)
def test_moe_speculative_tokens_equal_verifier_only(variant):
    """Self-speculative decoding (w4 drafts, w8 verifies) on an MoE stack:
    the verify forward routes each position as a dropless decode step, so
    every request's tokens equal verifier-only decode."""
    _, _, tm, tp = _pair(variant=variant)
    reqs = _reqs()
    kw = dict(BASE, kv_backend="paged", prefill_chunk=3,
              quantize_weights="squant")
    plain = _eng(tm, tp, **kw).generate(reqs)
    spec = _eng(tm, tp, speculative=True, draft_k=3, **kw)
    got = spec.generate(reqs)
    assert [c.tokens for c in got] == [c.tokens for c in plain]
    st = spec.stats()["scheduler"]
    assert st["spec_cycles"] > 0 and st["draft_tokens_proposed"] > 0


def test_moe_speculative_equals_reference_engine():
    """The same against the reference's speculative engine (whose drafter
    takes the unrolled layer list)."""
    jm, jp, tm, tp = _pair(scan_layers=False)
    reqs = _reqs()
    kw = dict(BASE, kv_backend="paged", prefill_chunk=0, speculative=True,
              draft_k=2)
    want = _jax_tokens(jm, jp, reqs, **kw)
    assert [c.tokens for c in _eng(tm, tp, **kw).generate(reqs)] == want


def test_moe_native_checkpoint_serves_reference_tokens(tmp_path):
    """``quant.apply``'s w8 tree of the MoE stack ((E, out, in) bank codes)
    saved as a native checkpoint, restored and staged by the weight store:
    the same tokens as the never-saved tree and as the reference engine
    serving the reference's serving tree of the same weights."""
    from repro_torch.quant import apply as tapply
    jm, jp, tm, tp = _pair()
    reqs = _reqs()
    kw = dict(BASE, kv_backend="paged", prefill_chunk=3)
    want = _jax_tokens(jm, japply.quantize_params_sharded(jp, 8), reqs, **kw)
    tree = tapply.quantize_params_sharded(tp, 8)
    bank = tree["stack"]["list"][0]["b0"]["moe"]["wdown"]
    assert bank["w_q"].shape == (4, 64, 128)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, tree, tapply.quant_tree_meta(8, "squant", 128))
    restored = ck.restore_serving(device="cpu")[0]
    for params in (tree, restored):
        eng = ServeEngine(tm, None, ServeConfig(**kw),
                          store=WeightStore(serving_params=params,
                                            device="cpu"), device="cpu")
        assert [c.tokens for c in eng.generate(reqs)] == want


@pytest.mark.parametrize("cfg", [dict(prefill_chunk=0),
                                 dict(prefill_chunk=3),
                                 dict(prefill_chunk=16,
                                      quantize_weights="squant")],
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_chameleon_paged_tokens_identical_to_reference(cfg):
    """chameleon-34b reduced (qk-norm, untied head) on the paged path."""
    jm, jp, tm, tp = _pair("chameleon-34b", "dense")
    assert tm.cfg.qk_norm and not tm.cfg.tie_embeddings
    reqs = _reqs()
    kw = dict(BASE, kv_backend="paged", **cfg)
    want = _jax_tokens(jm, jp, reqs, **kw)
    assert [c.tokens for c in _eng(tm, tp, **kw).generate(reqs)] == want
