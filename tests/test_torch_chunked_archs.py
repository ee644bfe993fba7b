"""Port vs reference: the ``mla``, ``sliding_window``,
``sliding_window+moe``, ``mamba`` and ``rwkv`` rows of
``tests/test_chunked_archs.py`` on the contiguous continuous scheduler, and
the round scheduler on each stack (float32, 2 layers, the reference's
weights carried across with ``convert.from_jax_params``).

For the monolithic oracle and every chunk width of the reference's sweep
(1, a non-dividing 3, 16 >= every prompt) the port engine's greedy tokens
equal the reference engine's on the same wave; teacher-forced agreement
against the monolithic oracle is at or above the reference's
``agreement_budget`` (1.0 for MLA: every token equal); a chunked admission
into a freed slot mid-flight gives the reference engine's tokens."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.equivalence import (agreement_budget,
                                             greedy_token_agreement,
                                             oracle_tokens)

torch.set_num_threads(1)

# label -> (registry arch, overrides): the reference sweep's rows
ARCHS = {"sliding_window": ("granite-3-8b", dict(n_layers=2, window=8)),
         "mla": ("minicpm3-4b", dict(n_layers=2)),
         "sliding_window+moe": ("mixtral-8x7b", dict(n_layers=2, window=8)),
         "mamba": ("jamba-1.5-large-398b",
                   dict(n_layers=2, block_pattern=("m", "a"), moe=None)),
         "rwkv": ("rwkv6-1.6b", dict(n_layers=2))}
BUDGETS = {"sliding_window": 0.95, "mla": 1.0, "sliding_window+moe": 0.8075,
           "mamba": 0.95, "rwkv": 0.95}
_PAIRS = {}


def _pair(label):
    """(reference model, reference params, port model, port params)."""
    if label not in _PAIRS:
        name, over = ARCHS[label]
        jc = dataclasses.replace(jax_get_config(name, reduced=True),
                                 dtype="float32", **over)
        tc = dataclasses.replace(get_config(name, reduced=True),
                                 dtype="float32", **over)
        jm = jax_build_model(jc)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        from repro_torch.models.model import build_model
        _PAIRS[label] = (jm, jp, build_model(tc), convert.from_jax_params(
            jax.device_get(jp), device="cpu"))
    return _PAIRS[label]


def _wave():
    """``tests/test_chunked_archs.py``'s admission wave."""
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(4):
        plen = int(rng.integers(5, 10))
        prompt = [int(t) for t in rng.integers(1, 200, size=plen)]
        reqs.append(Request(prompt, 8, request_id=i))
    return reqs


def _jreqs(reqs):
    return [jeng.Request(list(r.prompt), r.max_new_tokens,
                         request_id=r.request_id) for r in reqs]


def _tokens(outs):
    return {c.request_id: [int(t) for t in c.tokens] for c in outs}


BASE = dict(max_batch=4, max_len=48, scheduler="continuous")


@pytest.mark.parametrize("chunk", [0, 1, 3, 16])
@pytest.mark.parametrize("label", sorted(ARCHS))
def test_chunk_split_sweep_tokens_equal_reference_and_within_budget(
        label, chunk):
    """chunk 0 is the monolithic oracle; every width's tokens equal the
    reference engine's, and its agreement with the oracle (teacher-forced,
    the port's own) is at or above the composed budget."""
    jm, jp, tm, tp = _pair(label)
    reqs = _wave()
    kw = dict(BASE, prefill_chunk=chunk)
    want = _tokens(jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw))
                   .generate(_jreqs(reqs)))
    eng = ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")
    assert _tokens(eng.generate(reqs)) == want
    eng.close()
    if chunk == 0:
        return
    oracle_eng = ServeEngine(tm, tp, ServeConfig(**BASE), device="cpu")
    oracle = oracle_tokens(oracle_eng.generate(reqs))
    oracle_eng.close()
    eng = ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")
    budget = agreement_budget(eng.cfg, tm.cfg)
    assert budget == pytest.approx(BUDGETS[label])
    rep = greedy_token_agreement(eng, reqs, oracle)
    eng.close()
    assert rep.compared == sum(r.max_new_tokens for r in reqs)
    rep.assert_budget(budget, f"{label} chunk={chunk}")


@pytest.mark.parametrize("label", sorted(ARCHS))
def test_midflight_chunked_admission_tokens_equal_reference(label):
    """The reference's mid-flight leg: a chunked admission into a freed
    slot commits to a clock and left-pads to it over several chunks; the
    port's tokens and admission log equal the reference engine's."""
    jm, jp, tm, tp = _pair(label)
    reqs = [Request([1, 2, 3], 2, request_id=0),
            Request([5, 6, 7, 8, 9], 12, request_id=1),
            Request([11, 12, 13], 8, request_id=2)]
    kw = dict(max_batch=2, max_len=64, scheduler="continuous",
              prefill_chunk=2)
    jref = jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw))
    want = _tokens(jref.generate(_jreqs(reqs)))
    eng = ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")
    assert _tokens(eng.generate(reqs)) == want
    adm = {e["request_id"]: e for e in eng.scheduler.admission_log}
    jadm = {e["request_id"]: e for e in jref.scheduler.admission_log}
    assert adm[2]["chunks"] > 1
    assert (adm[2]["clock"], adm[2]["chunks"]) == \
        (jadm[2]["clock"], jadm[2]["chunks"])
    eng.close()


@pytest.mark.parametrize("label", sorted(ARCHS))
def test_round_scheduler_serves_each_stack(label):
    """The round scheduler (a fresh contiguous cache a round, monolithic
    prefill): tokens equal the reference engine's, fp and SQuant w8. The
    reference cannot run a real-quantized mamba (it reads ``dt_rank`` off
    ``dt_proj``'s kernel, which a QuantizedTensor stores (out, in)), so
    there the port's real-quantized engine is held to the reference's
    fake-quantized one (the same codes, dequantized to dense weights)."""
    jm, jp, tm, tp = _pair(label)
    reqs = _wave() + [Request([9, 8, 7, 6, 5, 4, 3, 2, 1, 2, 3], 5,
                              request_id=9)]
    for extra in ({}, dict(quantize_weights="squant", weight_bits=8,
                           dequantize_for_compute=False)):
        kw = dict(max_batch=3, max_len=48, scheduler="round", **extra)
        jkw = dict(kw, dequantize_for_compute=True) \
            if extra and label == "mamba" else kw
        want = _tokens(jeng.ServeEngine(jm, jp, jeng.ServeConfig(**jkw))
                       .generate(_jreqs(reqs)))
        eng = ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")
        assert _tokens(eng.generate(reqs)) == want
        eng.close()


@pytest.mark.parametrize("label", sorted(ARCHS))
def test_paged_backend_stays_gated(label):
    _, _, tm, tp = _pair(label)
    with pytest.raises(NotImplementedError, match="paged KV cache"):
        ServeEngine(tm, tp, ServeConfig(max_batch=2, max_len=32,
                                        scheduler="continuous",
                                        kv_backend="paged", block_size=8),
                    device="cpu")
