"""The port's paged KV cache (``serving/kvcache.PagedKVCache``) and paged
chunked admission, mirroring ``tests/test_kvcache_paged.py`` and
``tests/test_paged_chunked.py``: the block lifecycle, reservations and
backpressure, prefix hits with content checks, the partial-tail share,
copy-on-write, FIFO eviction, ``abandon_chunked_admit`` releasing pins and
budget, and ``check_invariants`` after every engine step. Weights are the
reference's (converted), float32, on the CPU; the oracle is the port's own
solo round engine (prompt at positions 0..L-1), as the reference's tests
use the reference's."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.kvcache import TRASH, PagedKVCache

torch.set_num_threads(1)

TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            head_dim=16, d_ff=64, vocab=256)
_TREES = {}


def _tiny(seed=0):
    """(port model, port params) — the reference's init, converted."""
    if seed not in _TREES:
        jcfg = dataclasses.replace(jax_get_config("granite-3-8b",
                                                  reduced=True), **TINY)
        jp = jax_build_model(jcfg).init(jax.random.PRNGKey(seed))
        _TREES[seed] = convert.from_jax_params(jax.device_get(jp),
                                               device="cpu")
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **TINY)
    return build_model(cfg), _TREES[seed]


def _paged(model, params, check=True, **over):
    base = dict(max_len=32, scheduler="continuous", max_slots=2,
                kv_backend="paged", block_size=4)
    base.update(over)
    eng = ServeEngine(model, params, ServeConfig(**base), device="cpu")
    if check:                              # the invariants after every step
        eng.on_step = lambda info: eng.scheduler.kv.check_invariants()
    return eng


def _solo_oracle(model, params, reqs, max_len=32):
    out = {}
    for r in reqs:
        eng = ServeEngine(model, params,
                          ServeConfig(max_batch=1, max_len=max_len),
                          device="cpu")
        out[r.request_id] = eng.generate([r])[0].tokens
    return out


def _kv_stats(eng):
    return eng.scheduler.stats()["kv"]


def _assert_no_leaks(eng):
    kv = _kv_stats(eng)
    assert kv["blocks_active"] == 0
    assert kv["blocks_reserved"] == 0
    assert (kv["blocks_free"] + kv["blocks_cached"] + kv["blocks_active"]
            + kv["blocks_trash"]) == kv["blocks_total"]
    eng.scheduler.kv.check_invariants()


def _stage_at_step(eng, step, params2):
    def hook(info):
        eng.scheduler.kv.check_invariants()
        if info["step"] == step and not eng.store.staged_pending:
            eng.store.stage(fp_params=params2, source="midrun", block=True)
    eng.on_step = hook


# ---------------------------------------------------------------------------
# identity with the solo oracle, retirement, reclamation
# ---------------------------------------------------------------------------

def test_paged_tokens_identical_to_solo_oracle_mixed_lengths():
    model, params = _tiny()
    reqs = [Request([1, 2, 3, 4, 5, 6], 8, request_id=0),
            Request([7, 8], 3, request_id=1),
            Request([9, 10, 11], 5, request_id=2),
            Request([4] * 11, 6, request_id=3)]
    oracle = _solo_oracle(model, params, reqs)
    eng = _paged(model, params)
    for c in eng.generate(reqs):
        assert c.tokens == oracle[c.request_id]
    sch = eng.scheduler.stats()
    assert sch["admitted"] == 4 and sch["retired"] == 4
    _assert_no_leaks(eng)


def test_paged_outlives_contiguous_admission_horizon():
    model, params = _tiny()
    reqs = [Request([1, 2, 3], 12, request_id=0),
            Request([5, 6, 7, 8], 12, request_id=1),
            Request([9, 10], 14, request_id=2)]
    oracle = _solo_oracle(model, params, reqs, max_len=16)
    eng = _paged(model, params, max_len=16)
    for c in eng.generate(reqs):
        assert c.tokens == oracle[c.request_id]
    _assert_no_leaks(eng)


def test_eos_retirement_reclaims_blocks_no_leak_across_waves():
    model, params = _tiny()
    reqs = [Request([1, 2, 3], 10, request_id=0),
            Request([5, 6, 7], 10, request_id=1),
            Request([11, 12], 4, request_id=2)]
    base = _paged(model, params).generate(reqs)
    eos = next(t for t in base[0].tokens[:6]
               if t not in base[1].tokens and t != 0)
    cut = base[0].tokens.index(eos) + 1
    eng = _paged(model, params, eos_id=eos)
    outs = eng.generate(reqs)
    assert outs[0].tokens == base[0].tokens[:cut]
    assert len(outs[1].tokens) == 10
    _assert_no_leaks(eng)
    for _ in range(3):
        eng.generate(reqs)
        _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# shared-prefix reuse + copy-on-write
# ---------------------------------------------------------------------------

SYS = [3, 1, 4, 1, 5, 9, 2, 6]                   # two full blocks at bs=4


def test_shared_prefix_cow_divergence_identical():
    model, params = _tiny()
    reqs = [Request(SYS + [10, 11], 6, request_id=0),
            Request(SYS + [12, 13, 14], 6, request_id=1),
            Request(list(SYS), 6, request_id=2)]
    oracle = _solo_oracle(model, params, reqs)
    eng = _paged(model, params)
    for c in eng.generate(reqs):
        assert c.tokens == oracle[c.request_id]
    kv = _kv_stats(eng)
    assert kv["prefix_hits"] >= 1
    assert kv["prefix_tokens_reused"] >= len(SYS)
    assert kv["cow_copies"] >= 1
    _assert_no_leaks(eng)


def test_identical_prompts_share_full_blocks():
    model, params = _tiny()
    prompt = [7, 7, 2, 9, 4, 4, 8, 1, 6]
    reqs = [Request(list(prompt), 5, request_id=i) for i in range(4)]
    oracle = _solo_oracle(model, params, reqs)
    eng = _paged(model, params)
    for c in eng.generate(reqs):
        assert c.tokens == oracle[c.request_id]
    kv = _kv_stats(eng)
    assert kv["prefix_hits"] >= 3
    assert kv["prefix_tokens_reused"] >= 3 * (len(prompt) // 4) * 4
    _assert_no_leaks(eng)


def test_prefix_hit_content_and_partial_tail_share():
    """White-box: a registered prompt's blocks hold exactly the K/V a solo
    prefill writes; a follow-up prompt that extends it pins the full blocks
    and the partial tail (its first ``fill`` positions), the gathered side
    cache holds the same values, and completing the admission COWs the tail
    block instead of writing into it."""
    model, params = _tiny()
    eng = _paged(model, params, check=False, max_len=32)
    kv = eng.scheduler.kv
    tree = eng.store.current.params
    first = Request(SYS + [21, 22], 4, request_id=0)      # L=10: tail fill 2
    kv.admit([(0, first)], [0], None, tree)
    kv.check_invariants()
    solo = kv.side_cache(1)
    _, solo = model.prefill(tree, {"tokens": torch.tensor([first.prompt])},
                            solo)
    tbl = kv._tables[0]
    leaf = lambda c: c["list"][0]["b0"]["k"]               # noqa: E731
    pool_k = leaf(kv._cache)[torch.from_numpy(tbl[:3].astype(np.int64))]
    assert torch.equal(pool_k.reshape(12, *pool_k.shape[2:])[:10],
                       leaf(solo)[0, :10])
    follow = Request(SYS + [21, 22, 23, 24, 25], 4, request_id=1)
    kv.reserve_pending(1, follow)
    lp, side = kv.begin_chunked_admit(1, follow)
    assert lp == len(SYS) + 2                               # 2 full + fill 2
    assert kv._pending_pins[1] == [int(tbl[0]), int(tbl[1]), int(tbl[2])]
    assert (kv._tables[1] == TRASH).all()                   # pins held out
    assert torch.equal(leaf(side)[0, :lp], leaf(solo)[0, :lp])
    lg, side = model.prefill_chunk(
        tree, {"tokens": torch.tensor([follow.prompt[lp:]])}, side)
    cows = kv.cow_copies
    kv.complete_chunked_admit(1, follow, lp, side, lg)
    assert kv.cow_copies == cows + 1
    assert kv._tables[1][:2].tolist() == tbl[:2].tolist()  # shared
    assert kv._tables[1][2] != tbl[2]                       # private copy
    kv.check_invariants()
    kv.retire(0)
    kv.retire(1)
    _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# pool exhaustion → admission backpressure; trash block; host snapshots
# ---------------------------------------------------------------------------

def test_pool_exhaustion_backpressures_admission_and_completes():
    model, params = _tiny()
    reqs = [Request([1, 2, 3, 4, 5], 7, request_id=0),
            Request([6, 7, 8, 9], 8, request_id=1)]
    oracle = _solo_oracle(model, params, reqs)
    eng = _paged(model, params, kv_blocks=5)
    for c in eng.generate(reqs):
        assert c.tokens == oracle[c.request_id]
    adm = {e["request_id"]: i
           for i, e in enumerate(eng.scheduler.admission_log)}
    assert adm[1] > adm[0]
    assert eng.scheduler.stats()["max_occupancy"] == 1
    _assert_no_leaks(eng)


def test_oversized_request_rejected_against_pool():
    model, params = _tiny()
    eng = _paged(model, params, kv_blocks=3)
    with pytest.raises(ValueError, match="KV blocks"):
        eng.generate([Request([1, 2, 3, 4, 5, 6, 7, 8], 8, request_id=0)])


def test_trash_block_duplicate_writes_are_harmless():
    """Three idle slots write their row into trash block 0 at every step
    (duplicate indices: which write lands is unspecified); poisoning the
    trash block before every step cannot change the live slot's tokens,
    because block 0 is never read unmasked."""
    model, params = _tiny()
    req = Request([5, 4, 3, 2, 1], 8, request_id=0)
    oracle = _solo_oracle(model, params, [req])
    eng = _paged(model, params, max_slots=4)

    def poison(info):
        kv = eng.scheduler.kv
        kv.check_invariants()
        for period in kv._cache["list"]:
            for t in period["b0"].values():
                t[TRASH] = 1e6
    eng.on_step = poison
    assert eng.generate([req])[0].tokens == oracle[0]
    _assert_no_leaks(eng)


def test_decode_pushes_snapshots_and_side_cache_is_its_own():
    """The device copies of the block tables and lengths are snapshots: the
    host mutates its arrays right after a decode is issued. An admission
    side cache never aliases the pool."""
    model, params = _tiny()
    eng = _paged(model, params, check=False, max_slots=2)
    kv = eng.scheduler.kv
    tree = eng.store.current.params
    kv.admit([(0, Request([1, 2, 3, 4, 5], 6, request_id=0))], [0], None,
             tree)
    kv.decode(tree, torch.zeros(2, dtype=torch.int32), [0])
    pushed = kv._cache["block_tables"].clone()
    kv.retire(0)                               # mutates the host table
    assert (kv._tables == TRASH).all()
    assert torch.equal(kv._cache["block_tables"], pushed)
    assert int(pushed[0, 0]) != TRASH
    pool = {t.untyped_storage().data_ptr()
            for t in (kv._cache["list"][0]["b0"]["k"],)}
    side = kv.side_cache(1)
    assert side["list"][0]["b0"]["k"].untyped_storage().data_ptr() \
        not in pool
    _assert_no_leaks(eng)


# ---------------------------------------------------------------------------
# int8 pool
# ---------------------------------------------------------------------------

def test_quantized_pool_dtype_and_scale_shapes():
    model, params = _tiny()
    eng = _paged(model, params, quantize_kv=True)
    eng.generate([Request([1, 2, 3, 4, 5], 4, request_id=0)])
    kv = eng.scheduler.kv
    layer = kv._cache["list"][0]["b0"]
    assert layer["k"].dtype == torch.int8 and layer["v"].dtype == torch.int8
    for name in ("k_scale", "v_scale"):
        assert tuple(layer[name].shape) == (kv.num_blocks, kv.block_size, 1)
        assert layer[name].dtype == torch.float32
    st = _kv_stats(eng)
    assert st["quantize_kv"] is True
    fp = _paged(model, params)
    fp.generate([Request([1, 2, 3], 2, request_id=0)])
    assert st["bytes_per_position"] < _kv_stats(fp)["bytes_per_position"]
    _assert_no_leaks(eng)


def test_quantized_registry_cow_eviction_invariants():
    """Every block move carries codes and scales: prefix hits, COW, tight
    pool backpressure and chunked admission under quantize_kv, with the
    invariants after every step and no leak."""
    model, params = _tiny()
    reqs = [Request(SYS + [10, 11], 6, request_id=0),
            Request(SYS + [12, 13, 14], 6, request_id=1),
            Request(list(SYS), 6, request_id=2)]
    eng = _paged(model, params, quantize_kv=True)
    assert all(len(c.tokens) == 6 for c in eng.generate(reqs))
    kv = _kv_stats(eng)
    assert kv["prefix_hits"] >= 1 and kv["cow_copies"] >= 1
    assert kv["prefix_tokens_reused"] >= len(SYS)
    _assert_no_leaks(eng)
    tight = [Request([1, 2, 3, 4, 5], 7, request_id=0),
             Request([6, 7, 8, 9], 8, request_id=1)]
    eng2 = _paged(model, params, quantize_kv=True, kv_blocks=5)
    assert [len(c.tokens) for c in eng2.generate(tight)] == [7, 8]
    assert eng2.scheduler.stats()["max_occupancy"] == 1
    _assert_no_leaks(eng2)
    eng3 = _paged(model, params, quantize_kv=True, prefill_chunk=4)
    assert all(len(c.tokens) == 6 for c in eng3.generate(reqs))
    assert eng3.scheduler.stats()["chunk_steps"] > 0
    _assert_no_leaks(eng3)


def test_paged_weight_swap_flushes_prefix_cache():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    reqs = [Request(list(SYS), 5, request_id=0)]
    eng = _paged(model, params, max_slots=1)
    eng.generate(reqs)
    hits0 = _kv_stats(eng)["prefix_hits"]
    eng.store.stage(fp_params=params2, source="test", block=True)
    outs = eng.generate(reqs)
    fresh = _paged(model, params2, max_slots=1).generate(reqs)
    assert outs[0].tokens == fresh[0].tokens
    assert _kv_stats(eng)["prefix_hits"] == hits0
    _assert_no_leaks(eng)


def test_speculative_cache_operations_not_ported():
    """The speculative cache operations, once refused here (the name is
    kept from then), run on the paged backend: ``ensure_rows`` makes a
    write range private across a block boundary, ``verify`` writes and
    scores S positions a slot and advances the live slots, ``carry_logits``
    installs a chosen row, ``rewind`` returns the blocks to the slot's
    reservation, the invariants hold after each. The contiguous backend's
    ``rewind`` still raises (one shared clock)."""
    model, params = _tiny()
    eng = _paged(model, params, speculative=True)
    kv = eng.scheduler.kv
    assert isinstance(kv, PagedKVCache)
    sp = eng.store.current.params
    kv.admit([(None, Request([1, 2, 3, 4, 5, 6], 8, request_id=0))], [0],
             None, sp)
    resv = int(kv._slot_reserved[0])
    kv.ensure_rows(0, 6, 3)                  # positions 6..8: blocks 1, 2
    assert kv._tables[0, 2] != TRASH
    assert int(kv._slot_reserved[0]) == resv - 1
    kv.check_invariants()
    toks = torch.tensor([[7, 8, 9], [0, 0, 0]])
    lg, verdict = kv.verify(sp, toks, [0])
    assert lg.shape == (2, 3, 256) and verdict.shape == (2, 2)
    assert torch.equal(verdict, lg[:, :-1].argmax(-1))
    assert int(kv._lengths[0]) == 9 and int(kv._lengths[1]) == 0
    kv.carry_logits(lg, [0], [1])
    assert torch.equal(kv.logits[0], lg[0, 1])
    kv.rewind(0, 2)                          # back to 7: block 2 returned
    assert int(kv._lengths[0]) == 7 and kv._tables[0, 2] == TRASH
    assert int(kv._slot_reserved[0]) == resv
    kv.check_invariants()
    kv.retire(0)
    kv.check_invariants()
    cont = ServeEngine(model, params, ServeConfig(
        max_len=32, scheduler="continuous", max_slots=2), device="cpu")
    with pytest.raises(NotImplementedError, match="rewind"):
        cont.scheduler.kv.rewind(0, 1)


# ---------------------------------------------------------------------------
# paged x chunked admission (tests/test_paged_chunked.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sweep_setup():
    model, params = _tiny()
    reqs = [Request([1, 2, 3, 4, 5, 6], 8, request_id=0),
            Request([7, 8], 3, request_id=1),
            Request([9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19], 5,
                    request_id=2),
            Request([4, 3, 2], 6, request_id=3)]
    oracle = _solo_oracle(model, params, reqs)
    mono = {c.request_id: c.tokens
            for c in _paged(model, params).generate(reqs)}
    return model, params, reqs, oracle, mono


@pytest.mark.parametrize("chunk", [1, 3, 5, 64])
def test_chunk_split_sweep_identical(sweep_setup, chunk):
    model, params, reqs, oracle, mono = sweep_setup
    eng = _paged(model, params, prefill_chunk=chunk)
    for c in eng.generate(reqs):
        assert c.tokens == oracle[c.request_id], f"chunk={chunk} vs oracle"
        assert c.tokens == mono[c.request_id], f"chunk={chunk} vs monolithic"
    sch = eng.scheduler.stats()
    assert sch["admitted"] == 4 and sch["retired"] == 4
    assert sch["pendings_started"] >= 2
    assert sch["pendings_abandoned"] == 0
    expected = sum(-(-len(r.prompt) // chunk) for r in reqs)
    assert 0 < sch["chunk_steps"] <= expected
    _assert_no_leaks(eng)


def test_midflight_admission_with_residents_chunk1():
    model, params = _tiny()
    resident = Request([1, 2], 14, request_id=0)
    long_req = Request(list(range(2, 15)), 4, request_id=1)
    oracle = _solo_oracle(model, params, [resident, long_req])
    eng = _paged(model, params, max_slots=1, prefill_chunk=1)
    for c in eng.generate([resident, long_req]):
        assert c.tokens == oracle[c.request_id]
    adm = {e["request_id"]: e for e in eng.scheduler.admission_log}
    assert adm[1]["chunks"] == len(long_req.prompt)
    assert adm[1]["clock"] == len(long_req.prompt)
    _assert_no_leaks(eng)


def test_shared_prefix_chat_turn_chunks_suffix_only():
    model, params = _tiny()
    turn1 = Request(list(range(1, 11)), 4, request_id=0)
    turn2 = Request(list(range(1, 11)) + [51, 52, 53], 4, request_id=1)
    oracle = _solo_oracle(model, params, [turn1, turn2])
    eng = _paged(model, params, prefill_chunk=2)
    assert eng.generate([turn1])[0].tokens == oracle[0]
    assert eng.generate([turn2])[0].tokens == oracle[1]
    kv = _kv_stats(eng)
    assert kv["prefix_hits"] >= 1 and kv["prefix_tokens_reused"] >= 8
    adm = [e for e in eng.scheduler.admission_log if e["request_id"] == 1]
    assert adm[-1]["chunks"] == 3
    _assert_no_leaks(eng)


def test_repeated_force_swap_abandons_release_blocks_and_pins():
    model, params = _tiny(0)
    resident = Request(list(range(1, 9)), 12, request_id=0)
    eng = _paged(model, params, prefill_chunk=1, swap_deadline_ms=0.0)
    for it, seed in enumerate((1, 2, 3)):
        _, p2 = _tiny(seed)
        tail = [61 + 10 * it + j for j in range(6)]
        follower = Request(list(range(1, 9)) + tail, 4, request_id=1)
        _stage_at_step(eng, eng.scheduler.steps_total + 2, p2)
        outs = eng.generate([resident, follower])
        sch = eng.scheduler.stats()
        assert sch["pendings_abandoned"] == it + 1
        assert sch["forced_swaps"] == it + 1
        assert outs[0].forced_swaps == 1
        assert outs[1].weights_version == outs[0].weights_version + 1
        assert outs[1].tokens == _solo_oracle(model, p2, [follower])[1]
        assert len(outs[0].tokens) == resident.max_new_tokens
        _assert_no_leaks(eng)
    assert eng.store.stats()["forced_swaps"] == 3


def test_drain_waits_on_paged_pending_no_abandon():
    model, params = _tiny(0)
    _, params2 = _tiny(1)
    reqs = [Request([1, 2, 3], 3, request_id=0),
            Request(list(range(5, 17)), 8, request_id=1),
            Request([21, 22], 4, request_id=2)]
    eng = _paged(model, params, prefill_chunk=2, swap_deadline_ms=None)
    _stage_at_step(eng, 2, params2)
    outs = eng.generate(reqs)
    sch = eng.scheduler.stats()
    assert sch["pendings_abandoned"] == 0 and sch["forced_swaps"] == 0
    assert all(len(o.tokens) == r.max_new_tokens
               for o, r in zip(outs, reqs))
    _assert_no_leaks(eng)


def test_pins_survive_eviction_between_chunk_steps():
    model, params = _tiny()
    eng = _paged(model, params, prefill_chunk=1)
    seed_req = Request(list(range(1, 13)), 4, request_id=0)
    eng.generate([seed_req])                   # registers 3 full blocks
    kv = eng.scheduler.kv
    assert _kv_stats(eng)["blocks_cached"] == 3
    follow = Request(list(range(1, 9)) + [41, 42, 43], 4, request_id=1)
    tree = eng.store.acquire()[0].params
    kv.reserve_pending(0, follow)
    lp, side = kv.begin_chunked_admit(0, follow)
    assert lp == 8
    assert _kv_stats(eng)["blocks_cached"] == 1
    taken = [kv._alloc() for _ in range(len(kv._free))]
    taken.append(kv._alloc())                  # evicts the unpinned block
    assert kv.evictions == 1 and _kv_stats(eng)["blocks_cached"] == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        kv._alloc()
    for ph in taken:
        kv._unref(ph)
    logits = None
    for t in follow.prompt[lp:]:
        logits, side = eng._prefill_chunk(tree, {"tokens": torch.tensor(
            [[t]])}, side)
    kv.complete_chunked_admit(0, follow, lp, side, logits)
    kv.check_invariants()
    oracle = _solo_oracle(model, params, [follow])
    assert int(kv.logits[0].argmax()) == oracle[1][0]
    kv.retire(0)
    _assert_no_leaks(eng)


def test_abandon_chunked_admit_releases_pins_and_budget():
    model, params = _tiny()
    eng = _paged(model, params, check=False, prefill_chunk=2)
    eng.generate([Request(list(range(1, 13)), 2, request_id=0)])
    kv = eng.scheduler.kv
    before = (len(kv._free), len(kv._cached), kv._reserved)
    follow = Request(list(range(1, 9)) + [41, 42, 43], 4, request_id=1)
    kv.reserve_pending(1, follow)
    lp, _ = kv.begin_chunked_admit(1, follow)
    assert lp == 8 and kv._reserved > 0 and 1 in kv._pending_pins
    kv.abandon_chunked_admit(1)
    assert (len(kv._free), len(kv._cached), kv._reserved) == before
    assert 1 not in kv._pending_pins
    _assert_no_leaks(eng)


def test_eviction_pressure_end_to_end_tokens_still_identical():
    model, params = _tiny()
    eng = _paged(model, params, kv_blocks=9, prefill_chunk=1)
    seed_req = Request(list(range(1, 13)), 4, request_id=0)
    assert eng.generate([seed_req])[0].tokens == \
        _solo_oracle(model, params, [seed_req])[0]
    assert _kv_stats(eng)["blocks_cached"] == 3
    resident = Request(list(range(21, 27)), 10, request_id=1)
    follow = Request(list(range(1, 9)) + [41, 42, 43, 44, 45, 46], 2,
                     request_id=2)
    oracle = _solo_oracle(model, params, [resident, follow])
    for c in eng.generate([resident, follow]):
        assert c.tokens == oracle[c.request_id]
    kv = _kv_stats(eng)
    assert kv["evictions"] >= 1 and kv["prefix_hits"] >= 1
    _assert_no_leaks(eng)
