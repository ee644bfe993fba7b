"""Port vs reference: the continuous scheduler (``ServeEngine(scheduler=
"continuous")``) over the contiguous and paged KV caches, monolithic and
chunked admission, fp and SQuant w8 real-quantized weights, fp and int8 KV.

Greedy tokens of the port's engine equal the reference engine's on the same
(converted) weights wherever the reference asserts identity; int8 KV is held
to the reference's int8 tokens and to the ``int8_kv`` agreement budget
against the fp oracle. The scheduler behaviours of ``tests/test_scheduler.py``
(refill padding, queueing, EOS retirement, wave resets, chunked admission,
drain-then-swap, forced swaps, the starvation guard) are mirrored on the
port alone, without the reference's jit trace counts."""
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
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.equivalence import (AGREEMENT_BUDGETS,
                                             agreement_budget,
                                             greedy_token_agreement,
                                             oracle_tokens)

torch.set_num_threads(1)

TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            head_dim=16, d_ff=64, vocab=256)
_PAIRS = {}


def _pair(seed=0, **over):
    """(reference model, reference params, port model, port params)."""
    key = (seed, tuple(sorted(over.items())))
    if key not in _PAIRS:
        dims = dict(TINY, **over)
        jm = jax_build_model(dataclasses.replace(
            jax_get_config("granite-3-8b", reduced=True), **dims))
        jp = jm.init(jax.random.PRNGKey(seed))
        tm = build_model(dataclasses.replace(
            get_config("granite-3-8b", reduced=True), **dims))
        _PAIRS[key] = (jm, jp, tm, convert.from_jax_params(
            jax.device_get(jp), device="cpu"))
    return _PAIRS[key]


def _tiny(seed=0):
    _, _, tm, tp = _pair(seed)
    return tm, tp


def _eng(model, params, **kw):
    return ServeEngine(model, params, ServeConfig(**kw), device="cpu")


def _mixed_reqs():
    return [Request([1, 2, 3, 4, 5, 6], 8, request_id=0),
            Request([7, 8], 3, request_id=1),
            Request([9, 10, 11], 5, request_id=2),
            Request([4, 4, 4, 4], 6, request_id=3)]


def _both(pair, reqs, **kw):
    """Tokens of the reference engine and of the port's on one config."""
    jm, jp, tm, tp = pair
    jo = jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw)).generate(
        [jeng.Request(list(r.prompt), r.max_new_tokens,
                      request_id=r.request_id) for r in reqs])
    te = _eng(tm, tp, **kw)
    to = te.generate(reqs)
    return [[int(t) for t in c.tokens] for c in jo], \
        [c.tokens for c in to], te


# ---------------------------------------------------------------------------
# port vs reference: greedy tokens identical
# ---------------------------------------------------------------------------

CONFIGS = [
    dict(kv_backend="contiguous", prefill_chunk=0),
    dict(kv_backend="contiguous", prefill_chunk=3),
    dict(kv_backend="contiguous", prefill_chunk=16),
    dict(kv_backend="paged", prefill_chunk=0),
    dict(kv_backend="paged", prefill_chunk=3),
    dict(kv_backend="paged", prefill_chunk=16),
    dict(kv_backend="contiguous", prefill_chunk=3, quantize_weights="squant"),
    dict(kv_backend="paged", prefill_chunk=0, quantize_weights="squant"),
    dict(kv_backend="paged", prefill_chunk=16, quantize_weights="squant"),
]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_continuous_tokens_identical_to_reference(cfg):
    reqs = _mixed_reqs() + [Request([9, 8, 7, 6, 5, 4, 3, 2, 1], 4,
                                    request_id=4)]
    kw = dict(max_len=32, scheduler="continuous", max_slots=2, block_size=4,
              weight_bits=8, dequantize_for_compute=False, **cfg)
    jt, tt, te = _both(_pair(), reqs, **kw)
    assert tt == jt
    st = te.stats()["scheduler"]
    assert st["admitted"] == st["retired"] == len(reqs)
    if cfg["prefill_chunk"]:
        assert st["chunk_steps"] > 0 and st["pendings_started"] >= 2
    if cfg["kv_backend"] == "paged":
        te.scheduler.kv.check_invariants()
        assert st["kv"]["blocks_active"] == 0


@pytest.mark.parametrize("chunk", [0, 4])
def test_shared_prefix_chat_tokens_identical_to_reference(chunk):
    """A chat workload: one system prompt shared by every request, second
    turns extending first turns — prefix hits and copy-on-write in the port,
    the reference's tokens out."""
    sys_p = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]
    turn = [sys_p + [20 + i, 30 + i, 40 + i] for i in range(3)]
    reqs = [Request(t, 5, request_id=i) for i, t in enumerate(turn)]
    reqs += [Request(turn[i] + [60 + i, 61, 62], 4, request_id=3 + i)
             for i in range(3)]
    # six slots: second turns are admitted while their first turns decode,
    # so they share the first turns' partial tail blocks (COW)
    kw = dict(max_len=48, scheduler="continuous", max_slots=6, block_size=4,
              kv_backend="paged", prefill_chunk=chunk,
              quantize_weights="squant", weight_bits=8,
              dequantize_for_compute=False)
    jt, tt, te = _both(_pair(), reqs, **kw)
    assert tt == jt
    kv = te.stats()["scheduler"]["kv"]
    assert kv["prefix_hits"] >= 4 and kv["cow_copies"] >= 1
    te.scheduler.kv.check_invariants()


def test_paged_equals_contiguous_inside_port():
    """The paged engine (many slots, chunked) against the contiguous engine
    with one slot — no left padding, so both see positions 0..L-1 — give
    the same tokens; a multi-slot contiguous run pads prompts to the shared
    clock and attends the pad tokens, as the reference does."""
    model, params = _tiny()
    reqs = _mixed_reqs() + [Request([2] * 9 + [7], 6, request_id=4)]
    paged = _eng(model, params, max_len=32, scheduler="continuous",
                 max_slots=3, kv_backend="paged", block_size=4,
                 prefill_chunk=3).generate(reqs)
    solo = _eng(model, params, max_len=32, scheduler="continuous",
                max_slots=1).generate(reqs)
    assert [c.tokens for c in paged] == [c.tokens for c in solo]


def test_int8_kv_matches_reference_and_agreement_budget():
    """int8 KV on the paged pool: tokens equal the reference's int8-KV
    engine's, and teacher-forced agreement with the fp paged oracle meets
    the reference's ``int8_kv`` budget (0.98) at this width (d_model 128,
    head_dim 32; at d_model 32 the reference itself measures ~0.97)."""
    pair = _pair(0, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
                 d_ff=256)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(1, 256, size=int(rng.integers(3, 12)))
                    .tolist(), 16, request_id=i) for i in range(8)]
    kw = dict(max_len=64, scheduler="continuous", max_slots=4,
              kv_backend="paged", block_size=4)
    jt, tt, te = _both(pair, reqs, quantize_kv=True, **kw)
    assert tt == jt
    assert te.scheduler.kv._cache["list"][0]["b0"]["k"].dtype == torch.int8
    _, _, tm, tp = pair
    oracle = oracle_tokens(_eng(tm, tp, **kw).generate(reqs))
    q = _eng(tm, tp, quantize_kv=True, **kw)
    budget = agreement_budget(q.cfg, tm.cfg)
    assert budget == AGREEMENT_BUDGETS["int8_kv"] == 0.98
    rep = greedy_token_agreement(q, reqs, oracle)
    assert rep.compared == 8 * 16
    rep.assert_budget(budget, label="int8 KV, d_model 128")
    fp = greedy_token_agreement(_eng(tm, tp, **kw), reqs, oracle)
    assert fp.rate == 1.0


def test_int8_kv_contiguous_and_chunked_compose():
    _, _, tm, tp = _pair()
    reqs = _mixed_reqs()
    kw = dict(max_len=32, scheduler="continuous", max_slots=2,
              quantize_kv=True, prefill_chunk=4)
    jt, tt, _ = _both(_pair(), reqs, **kw)
    assert tt == jt


def test_speculative_still_not_ported():
    """Speculative decoding, once refused here (the name is kept from
    then), serves on the paged continuous path: its tokens equal the
    reference engine's speculative tokens and the port's own verifier-only
    tokens on the same config, and its cycle counters the reference's."""
    kw = dict(max_len=32, scheduler="continuous", max_slots=2,
              kv_backend="paged", block_size=4, speculative=True, draft_k=2)
    jt, tt, te = _both(_pair(), _mixed_reqs(), **kw)
    assert tt == jt
    model, params = _tiny()
    plain = _eng(model, params, **dict(kw, speculative=False))
    assert [c.tokens for c in plain.generate(_mixed_reqs())] == tt
    st = te.scheduler.stats()
    assert st["spec_cycles"] > 0 and st["draft_tokens_accepted"] > 0
    te.scheduler.kv.check_invariants()


# ---------------------------------------------------------------------------
# scheduler behaviour (tests/test_scheduler.py, on the port)
# ---------------------------------------------------------------------------

def test_mixed_length_batch_identical_to_round():
    model, params = _tiny()
    ro = _eng(model, params, max_batch=4, max_len=32).generate(_mixed_reqs())
    cont = _eng(model, params, max_batch=4, max_len=32,
                scheduler="continuous")
    co = cont.generate(_mixed_reqs())
    assert [o.tokens for o in ro] == [o.tokens for o in co]
    sch = cont.stats()["scheduler"]
    assert sch["steps"] == 8 and sch["waves"] == 1 and sch["retired"] == 4


def test_refill_admission_equivalent_to_round_padding():
    model, params = _tiny()
    reqs = [Request([1, 2, 3], 2, request_id=0),
            Request([5, 6, 7, 8, 9], 12, request_id=1),
            Request([11, 12], 4, request_id=2)]
    cont = _eng(model, params, max_batch=2, max_len=32,
                scheduler="continuous")
    co = cont.generate(reqs)
    adm = {e["request_id"]: e for e in cont.scheduler.admission_log}
    assert adm[2]["clock"] > adm[0]["clock"] == adm[1]["clock"] == 5
    rnd = _eng(model, params, max_batch=2, max_len=32)
    ctrl = rnd.generate([Request(reqs[2].prompt, 4, request_id=2),
                         Request([3] * adm[2]["clock"], 1, request_id=99)])
    assert co[2].tokens == ctrl[0].tokens
    assert co[1].tokens == rnd.generate([reqs[0], reqs[1]])[1].tokens


def test_admission_queues_when_all_slots_busy():
    model, params = _tiny()
    cont = _eng(model, params, max_batch=2, max_len=64,
                scheduler="continuous")
    reqs = [Request([1, 2, 3], 3 + 2 * (i % 2), request_id=i)
            for i in range(5)]
    outs = cont.generate(reqs)
    assert all(len(o.tokens) == r.max_new_tokens
               for o, r in zip(outs, reqs))
    sch = cont.stats()["scheduler"]
    assert sch["admitted"] == 5 and sch["max_occupancy"] <= 2
    clocks = [e["clock"] for e in cont.scheduler.admission_log]
    assert max(np.bincount(clocks)) <= 2


def test_eos_retirement_frees_slot_for_queued_request():
    model, params = _tiny()
    reqs = [Request([1, 2, 3], 10, request_id=0),
            Request([5, 6, 7], 10, request_id=1),
            Request([11, 12], 4, request_id=2)]

    def run(eos):
        eng = _eng(model, params, max_batch=2, max_len=32, eos_id=eos,
                   scheduler="continuous")
        return eng, eng.generate(reqs)

    _, base = run(-1)
    eos = next(t for t in base[0].tokens[:6]
               if t not in base[1].tokens and t != 0)
    cut = base[0].tokens.index(eos) + 1
    eng, outs = run(eos)
    assert outs[0].tokens == base[0].tokens[:cut]
    assert len(outs[1].tokens) == 10
    adm = {e["request_id"]: e for e in eng.scheduler.admission_log}
    assert adm[2]["slot"] == adm[0]["slot"]
    assert adm[2]["clock"] < adm[1]["clock"] + 10


def test_wave_reset_reuses_pool_within_max_len_horizon():
    model, params = _tiny()
    reqs = [Request([1 + i, 2, 3], 10, request_id=i) for i in range(4)]
    ro = _eng(model, params, max_batch=2, max_len=16).generate(reqs)
    cont = _eng(model, params, max_batch=2, max_len=16,
                scheduler="continuous")
    co = cont.generate(reqs)
    assert [o.tokens for o in ro] == [o.tokens for o in co]
    assert cont.stats()["scheduler"]["waves"] == 2
    assert [e["clock"] for e in cont.scheduler.admission_log] == [3, 3, 3, 3]


def test_oversized_and_zero_budget_requests():
    model, params = _tiny()
    eng = _eng(model, params, max_batch=2, max_len=16,
               scheduler="continuous")
    with pytest.raises(ValueError, match="exceeds"):
        eng.generate([Request([1] * 10, 10)])
    outs = _eng(model, params, max_batch=2, max_len=32,
                scheduler="continuous").generate(
        [Request([1, 2], 0, request_id=7), Request([1, 2], 3, request_id=8)])
    assert outs[0].tokens == [] and len(outs[1].tokens) == 3


@pytest.mark.parametrize("chunk", [1, 2, 5, 6, 7])
def test_chunked_fresh_wave_identical_to_monolithic(chunk):
    model, params = _tiny()
    mono = _eng(model, params, max_batch=4, max_len=32,
                scheduler="continuous")
    chunked = _eng(model, params, max_batch=4, max_len=32,
                   scheduler="continuous", prefill_chunk=chunk)
    chunked.scheduler.step_log = steps = []
    mo = mono.generate(_mixed_reqs())
    co = chunked.generate(_mixed_reqs())
    assert [o.tokens for o in mo] == [o.tokens for o in co]
    ms, cs = mono.stats()["scheduler"], chunked.stats()["scheduler"]
    assert cs["steps"] == ms["steps"] == 8
    assert cs["chunk_steps"] == -(-6 // chunk)
    assert cs["pendings_started"] == 1 and cs["pendings_abandoned"] == 0
    assert steps and all("step_ms" in e and "chunk_ms" in e for e in steps)
    assert set(cs["step_ms"]) == {"p50", "p95", "p99"}


def test_chunked_midflight_admission_equivalent_at_equal_padding():
    model, params = _tiny()
    reqs = [Request([1, 2, 3], 2, request_id=0),
            Request([5, 6, 7, 8, 9], 12, request_id=1),
            Request([11, 12], 4, request_id=2)]
    cont = _eng(model, params, max_batch=2, max_len=64,
                scheduler="continuous", prefill_chunk=2)
    co = cont.generate(reqs)
    adm = {e["request_id"]: e for e in cont.scheduler.admission_log}
    assert adm[2]["clock"] == 12 and adm[2]["chunks"] == 6
    rnd = _eng(model, params, max_batch=2, max_len=64)
    ctrl = rnd.generate([Request(reqs[2].prompt, 4, request_id=2),
                         Request([3] * adm[2]["clock"], 1, request_id=99)])
    assert co[2].tokens == ctrl[0].tokens
    assert co[1].tokens == rnd.generate([reqs[0], reqs[1]])[1].tokens


def test_chunked_admits_prompt_longer_than_clock():
    model, params = _tiny()
    long_prompt = [7, 3, 9, 4, 2, 8, 6, 1, 5, 2, 4, 6]
    reqs = [Request([1, 2, 3], 2, request_id=0),
            Request([5, 6, 7], 24, request_id=1),
            Request(long_prompt, 4, request_id=2)]
    cont = _eng(model, params, max_batch=2, max_len=64,
                scheduler="continuous", prefill_chunk=4)
    co = cont.generate(reqs)
    adm = {e["request_id"]: e for e in cont.scheduler.admission_log}
    assert adm[2]["clock"] >= len(long_prompt) > adm[0]["clock"]
    ctrl = _eng(model, params, max_batch=2, max_len=64).generate(
        [Request(long_prompt, 4, request_id=2),
         Request([3] * adm[2]["clock"], 1, request_id=99)])
    assert co[2].tokens == ctrl[0].tokens


def test_chunk_one_midflight_waits_for_empty_pool():
    model, params = _tiny()
    reqs = [Request([1, 2, 3], 4, request_id=0),
            Request([5, 6, 7, 8], 6, request_id=1),
            Request([11, 12], 3, request_id=2)]
    cont = _eng(model, params, max_batch=2, max_len=32,
                scheduler="continuous", prefill_chunk=1)
    co = cont.generate(reqs)
    adm = {e["request_id"]: e for e in cont.scheduler.admission_log}
    assert adm[2]["clock"] == 2
    assert cont.stats()["scheduler"]["waves"] == 2
    solo = _eng(model, params, max_batch=2, max_len=32).generate([reqs[2]])
    assert co[2].tokens == solo[0].tokens


def _stage_at_step(eng, step, params2):
    def hook(info):
        if info["step"] == step and not eng.store.staged_pending:
            eng.store.stage(fp_params=params2, source="midrun", block=True)
    eng.on_step = hook


def test_chunked_pending_drains_before_swap():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    eng = _eng(model, params, max_batch=2, max_len=64,
               scheduler="continuous", prefill_chunk=2,
               swap_deadline_ms=None)
    reqs = [Request([1, 2, 3], 2, request_id=0),
            Request([5, 6, 7, 8, 9], 12, request_id=1),
            Request([11, 12], 4, request_id=2),
            Request([13, 14], 3, request_id=3)]
    _stage_at_step(eng, 5, params2)
    outs = eng.generate(reqs)
    assert [o.weights_version for o in outs] == [1, 1, 1, 2]
    assert all(o.forced_swaps == 0 for o in outs)
    st = eng.stats()
    assert st["scheduler"]["pendings_abandoned"] == 0
    assert st["scheduler"]["forced_swaps"] == 0
    assert st["weights"]["swaps"] == 1 and st["weights"]["drains"] == 1


def test_force_swap_abandons_pending_and_requeues():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    eng = _eng(model, params, max_batch=2, max_len=64,
               scheduler="continuous", prefill_chunk=2, swap_deadline_ms=0.0)
    reqs = [Request([1, 2, 3], 2, request_id=0),
            Request([5, 6, 7, 8, 9], 16, request_id=1),
            Request([11, 12], 4, request_id=2)]
    _stage_at_step(eng, 5, params2)
    outs = eng.generate(reqs)
    st = eng.stats()
    assert st["scheduler"]["pendings_abandoned"] == 1
    assert st["scheduler"]["forced_swaps"] == 1
    assert st["weights"]["forced_swaps"] == 1
    assert outs[1].forced_swaps == 1 and outs[2].weights_version == 2
    adm = [e for e in eng.scheduler.admission_log if e["request_id"] == 2]
    assert adm[-1]["version"] == 2
    ctrl = _eng(model, params2, max_batch=2, max_len=64).generate(
        [Request(reqs[2].prompt, 4, request_id=2),
         Request([3] * adm[-1]["clock"], 1, request_id=99)])
    assert outs[2].tokens == ctrl[0].tokens


@pytest.mark.parametrize("chunk", [4, 0])
@pytest.mark.parametrize("backend", ["contiguous", "paged"])
def test_starvation_guard_bounds_head_skips(chunk, backend):
    model, params = _tiny()
    long_req = Request([9] * 20, 4, request_id=2)
    shorts = [Request([1 + i, 2], 3 + 3 * (i % 2), request_id=10 + i)
              for i in range(6)]
    reqs = shorts[:2] + [long_req] + shorts[2:]
    # the paged pool fits the long request only when the shorts leave room
    eng = _eng(model, params, max_batch=2, max_len=64,
               scheduler="continuous", prefill_chunk=chunk,
               starvation_limit=2, kv_backend=backend, block_size=4,
               kv_blocks=8 if backend == "paged" else 0)
    outs = eng.generate(reqs)
    assert all(len(o.tokens) == r.max_new_tokens
               for o, r in zip(outs, reqs))
    order = [e["request_id"] for e in eng.scheduler.admission_log]
    assert order.index(2) < len(order) - 2
    assert eng.scheduler._head_skips == 0


def test_drain_fully_before_swap():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    eng = _eng(model, params, max_batch=2, max_len=64,
               scheduler="continuous", swap_deadline_ms=None)
    reqs = [Request([1, 2, 3], 4, request_id=0),
            Request([4, 5, 6], 12, request_id=1),
            Request([7, 8], 4, request_id=2),
            Request([9, 10], 4, request_id=3)]
    _stage_at_step(eng, 2, params2)
    outs = eng.generate(reqs)
    assert [o.weights_version for o in outs] == [1, 1, 2, 2]
    assert all(o.forced_swaps == 0 for o in outs)
    adm = {e["request_id"]: e for e in eng.scheduler.admission_log}
    assert adm[2]["version"] == adm[3]["version"] == 2
    st = eng.stats()
    assert st["scheduler"]["drains"] == 1
    assert st["scheduler"]["forced_swaps"] == 0
    assert st["weights"]["swaps"] == 1 and st["weights"]["forced_swaps"] == 0
    assert st["weights"]["last_drain_in_flight"] == 2


def test_swap_deadline_forces_mid_flight_swap():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    eng = _eng(model, params, max_batch=2, max_len=64,
               scheduler="continuous", swap_deadline_ms=0.0)
    reqs = [Request([1, 2, 3], 10, request_id=0),
            Request([4, 5, 6], 10, request_id=1),
            Request([7, 8], 4, request_id=2)]
    _stage_at_step(eng, 2, params2)
    outs = eng.generate(reqs)
    assert [o.weights_version for o in outs] == [1, 1, 2]
    assert [o.forced_swaps for o in outs] == [1, 1, 0]
    st = eng.stats()
    assert st["scheduler"]["forced_swaps"] == 1
    assert st["weights"]["forced_swaps"] == 1
    base = _eng(model, params, max_batch=2, max_len=64,
                scheduler="continuous").generate(reqs)
    assert outs[0].tokens[:2] == base[0].tokens[:2]
    assert outs[0].tokens != base[0].tokens


def test_drain_dip_smaller_than_round_blocking():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    reqs = [Request([1, 2, 3], 4, request_id=0),
            Request([4, 5, 6], 20, request_id=1),
            Request([7, 8], 4, request_id=2)]
    cont = _eng(model, params, max_batch=2, max_len=64,
                scheduler="continuous", swap_deadline_ms=0.0)
    _stage_at_step(cont, 2, params2)
    cont.scheduler.step_log = steps = []
    cont.generate(reqs)
    post = [e for e in steps if e["version"] == 2]
    assert post and max(e["recorded"] for e in post) >= 2
    assert cont.stats()["scheduler"]["steps"] < 20 + 4
