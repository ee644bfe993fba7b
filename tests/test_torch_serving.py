"""Port vs reference: the slice as a whole. ``ServeEngine`` with the round
scheduler over a contiguous KV cache — fp weights and SQuant w8 / w4
real-quantized — must emit the same greedy tokens as the reference engine on
the same (converted) weights, float32, mixed prompt lengths, two rounds,
EOS truncation. Every config gate raises as in the reference; speculative
decoding serves on the CPU in every combination, with the tokens of the
same engine without it."""
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
from repro_torch.models.model import build_model
from repro_torch.quant.qtypes import QuantizedTensor
from repro_torch.serving import engine as teng
from repro_torch.serving.api import Completion, Request, SchedulerStats
from repro_torch.serving.sampling import sample
from repro_torch.serving.weights import WeightStore

# small shapes: one thread a process, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

PROMPTS = [[1, 2, 3], [5], [7, 8, 9, 10, 11], [20, 21], [3, 3], [9]]
NEW = [6, 4, 8, 5, 8, 3]


@pytest.fixture(scope="module")
def pair():
    jcfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                               dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(dataclasses.replace(
        get_config("granite-3-8b", reduced=True), dtype="float32"))
    tparams = convert.from_jax_params(jax.device_get(jparams), device="cpu")
    return jmodel, jparams, tmodel, tparams


def _generate(pair, eos_id=-1, **kw):
    jmodel, jparams, tmodel, tparams = pair
    kw = dict(max_batch=4, max_len=32, eos_id=eos_id, **kw)
    je = jeng.ServeEngine(jmodel, jparams, jeng.ServeConfig(**kw))
    te = teng.ServeEngine(tmodel, tparams, teng.ServeConfig(**kw),
                          device="cpu")
    jreq = [jeng.Request(p, n, request_id=i)
            for i, (p, n) in enumerate(zip(PROMPTS, NEW))]
    treq = [Request(p, n, request_id=i)
            for i, (p, n) in enumerate(zip(PROMPTS, NEW))]
    return je, te, je.generate(jreq), te.generate(treq)


@pytest.mark.parametrize("quant,bits", [(None, 8), ("squant", 8),
                                        ("squant", 4), ("rtn", 8)])
def test_greedy_tokens_identical_to_reference(pair, quant, bits):
    je, te, jout, tout = _generate(pair, quantize_weights=quant,
                                   weight_bits=bits,
                                   dequantize_for_compute=False)
    assert [c.request_id for c in tout] == list(range(6))
    for jc, tc, n in zip(jout, tout, NEW):
        assert isinstance(tc, Completion) and len(tc.tokens) == n
        assert tc.tokens == [int(t) for t in jc.tokens]
        assert tc.weights_version == 1 and tc.steps == n
    st = te.stats()
    assert st["rounds"] == 2 and isinstance(st["scheduler"], SchedulerStats)
    assert st["scheduler"].kind == "round"
    assert st["scheduler"].steps == je.stats()["scheduler"].steps
    if quant:
        wq = te.params["stack"]["list"][0]["b0"]["attn"]["wq"]["w"]
        assert isinstance(wq, QuantizedTensor) and wq.bits == bits
        assert te.quant_report.summary().startswith(f"{quant} w{bits}: 28 ")
    else:
        assert te.quant_report is None


def test_fake_quant_serving_identical(pair):
    _, _, jout, tout = _generate(pair, quantize_weights="squant",
                                 weight_bits=4, dequantize_for_compute=True)
    assert [c.tokens for c in tout] == [[int(t) for t in c.tokens]
                                        for c in jout]


def test_eos_truncation_matches(pair):
    _, _, base, _ = _generate(pair)
    eos = int(base[2].tokens[2])            # a token the model does emit
    _, _, jout, tout = _generate(pair, eos_id=eos)
    assert [c.tokens for c in tout] == [[int(t) for t in c.tokens]
                                        for c in jout]
    assert tout[2].tokens[-1] == eos and len(tout[2].tokens) <= 3
    # per-request override: -1 never stops
    _, _, tmodel, tparams = pair
    te = teng.ServeEngine(tmodel, tparams,
                          teng.ServeConfig(max_len=32, eos_id=eos),
                          device="cpu")
    out = te.generate([Request(PROMPTS[2], 8, eos_id=-1)])
    assert len(out[0].tokens) == 8 and out[0].request_id >= 1 << 20


def test_request_validation_and_hooks(pair):
    _, _, tmodel, tparams = pair
    te = teng.ServeEngine(tmodel, tparams, teng.ServeConfig(max_len=16),
                          device="cpu")
    with pytest.raises(ValueError, match="exceeds"):
        te.generate([Request([1] * 10, 8)])
    seen = []
    te.on_step = seen.append
    te.generate([Request([1, 2], 3), Request([4], 2)])
    assert [s["recorded"] for s in seen] == [2, 2, 1]
    with pytest.raises(ValueError):
        teng.ServeEngine(tmodel, None, teng.ServeConfig(), device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        teng.ServeEngine(tmodel, tparams, teng.ServeConfig(scheduler="x"),
                         device="cpu")


@pytest.mark.parametrize("idx", range(len(jeng.CONFIG_GATES)))
def test_config_gates_raise_as_reference(idx):
    probes = [dict(prefill_chunk=-1), dict(kv_backend="nope"),
              dict(kv_backend="paged", scheduler="continuous", block_size=0),
              dict(kv_backend="paged", scheduler="continuous", block_size=7,
                   max_len=64),
              dict(kv_backend="paged", scheduler="continuous", kv_blocks=-1),
              dict(speculative=True, draft_k=0, kv_backend="paged",
                   scheduler="continuous"),
              dict(speculative=True, draft_bits=9, kv_backend="paged",
                   scheduler="continuous"),
              dict(kv_backend="paged"), dict(speculative=True),
              dict(speculative=True, quantize_kv=True, kv_backend="paged",
                   scheduler="continuous"),
              dict(speculative=True, temperature=0.5, kv_backend="paged",
                   scheduler="continuous")]
    jg, tg = jeng.CONFIG_GATES[idx], teng.CONFIG_GATES[idx]
    assert jg.name == tg.name and jg.error is tg.error
    assert len(teng.CONFIG_GATES) == len(probes)
    with pytest.raises(jg.error) as je:
        jeng.ServeConfig(**probes[idx])
    with pytest.raises(tg.error) as te:
        teng.ServeConfig(**probes[idx])
    assert str(je.value) == str(te.value)


def test_arch_gates_and_config_fields_kept():
    assert [g.name for g in teng.ARCH_GATES] == \
        [g.name for g in jeng.ARCH_GATES]
    a = {f.name: f.default for f in dataclasses.fields(jeng.ServeConfig)}
    b = {f.name: f.default for f in dataclasses.fields(teng.ServeConfig)}
    assert a == b


@pytest.mark.parametrize("kw", [
    dict(scheduler="continuous", kv_backend="paged", speculative=True),
    dict(scheduler="continuous", kv_backend="paged", speculative=True,
         prefill_chunk=4),
    dict(scheduler="continuous", kv_backend="paged", speculative=True,
         draft_bits=8),
    dict(scheduler="continuous", kv_backend="paged", speculative=True,
         draft_k=2, block_size=8),
    dict(scheduler="continuous", kv_backend="paged", speculative=True,
         quantize_weights="squant", dequantize_for_compute=False)])
def test_unported_combinations_raise(pair, kw):
    """Speculative decoding, the last valid configuration the port once
    refused (the name is kept from then), now builds and serves on the CPU
    whatever it is combined with: the same tokens as the same engine with
    ``speculative=False``, and the (target, draft) pair staged."""
    _, _, tmodel, tparams = pair
    reqs = [Request([1, 2, 3], 6, request_id=0), Request([4], 5,
                                                         request_id=1)]
    te = teng.ServeEngine(tmodel, tparams, teng.ServeConfig(**kw),
                          device="cpu")
    out = te.generate(reqs)
    ref = teng.ServeEngine(tmodel, tparams, teng.ServeConfig(
        **dict(kw, speculative=False)), device="cpu").generate(reqs)
    assert [c.tokens for c in out] == [c.tokens for c in ref]
    assert [len(c.tokens) for c in out] == [6, 5]
    assert te.store.current.draft_params is not None
    st = te.scheduler.stats()
    assert st["speculative"] and st["spec_cycles"] > 0
    te.scheduler.kv.check_invariants()


@pytest.mark.parametrize("kw", [
    dict(scheduler="continuous"),
    dict(scheduler="continuous", kv_backend="paged"),
    dict(quantize_kv=True),
    dict(scheduler="continuous", prefill_chunk=4),
    dict(scheduler="continuous", kv_backend="paged", quantize_kv=True,
         prefill_chunk=4)])
def test_formerly_unported_combinations_serve(pair, kw):
    _, _, tmodel, tparams = pair
    te = teng.ServeEngine(tmodel, tparams, teng.ServeConfig(
        max_len=32, **kw), device="cpu")
    out = te.generate([Request([1, 2, 3], 3), Request([4], 2)])
    assert [len(c.tokens) for c in out] == [3, 2]


def test_weight_store_stage_and_swap_between_rounds(pair, tmp_path):
    _, _, tmodel, tparams = pair
    te = teng.ServeEngine(tmodel, tparams, teng.ServeConfig(
        max_batch=2, max_len=32, quantize_weights="squant", weight_bits=8,
        dequantize_for_compute=False), device="cpu")
    store: WeightStore = te.store
    assert store.version == 1 and not store.staged_pending
    store.stage(tparams, source="again", block=True)
    assert store.staged_pending and store.staged_info().version == 2
    out = te.generate([Request([1, 2], 2), Request([3], 2), Request([4], 2)])
    assert {c.weights_version for c in out} == {2}      # swapped at round 1
    store.stage(tparams, source="bg")                   # background worker
    assert store.wait_staged(2)
    st = store.stats()
    assert st["versions_built"] == 3 and st["swaps"] == 1
    with pytest.raises(ValueError):
        store.stage()
    store.watch(str(tmp_path), poll_s=0.01)         # checkpoint hot-reload
    assert store.stats()["watching"]
    with pytest.raises(RuntimeError, match="already watching"):
        store.watch(str(tmp_path))
    te.close()
    assert not store.stats()["watching"]


def test_sampling(rng):
    lg = torch.from_numpy(rng.normal(size=(4, 50)).astype(np.float32))
    assert sample(lg).tolist() == lg.argmax(-1).tolist()
    g = torch.Generator().manual_seed(3)
    a = sample(lg, g, temperature=1.0, top_k=5)
    top5 = lg.topk(5, dim=-1).indices
    assert all(int(a[i]) in top5[i].tolist() for i in range(4))
    g2 = torch.Generator().manual_seed(3)
    assert sample(lg, g2, temperature=1.0, top_k=5).tolist() == a.tolist()
    assert a.dtype == torch.int32
