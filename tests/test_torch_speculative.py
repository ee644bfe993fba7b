"""Self-speculative decoding on the port: the w4 quantization of a
checkpoint drafts for the w8 verifier on the paged continuous scheduler,
held against the reference (``tests/test_speculative.py``) on its tiny
configuration (2 layers, d 32, vocab 256, float32, the reference's weights
through ``convert.from_jax_params``).

On the CPU (every test not marked ``gpu``): tokens equal to the reference's
speculative engine and to the port's verifier-only engine, with the
reference's cycle counters, for several ``(draft_k, block_size)``, an fp
target, chunked admission and EOS retirement; the w4 draft tree's codes
equal to the reference's ``make_draft_quantize_fn``; a (target, draft) pair
swapped by the ``WeightStore``; ``rewind``/``ensure_rows`` invariants under
copy-on-write and block pressure; ``verify_step`` row j bit-identical to a
decode step at that position; the capture bookkeeping (one ``verify`` graph
per S, one ``draft_chain`` graph per ``k_eff``) with a stand-in graph. On a
GPU (``gpu``): the row equality through the kernels, bf16 and float32,
eager and captured, and a captured speculative engine's tokens equal to the
verifier-only engine's. Run those with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_speculative.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.core.pipeline import quantize_tree
from repro_torch.models.model import build_model
from repro_torch.quant.qtypes import QuantizedTensor
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine, _StepGraph
from repro_torch.serving.weights import WeightStore, make_draft_quantize_fn

torch.set_num_threads(1)

TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            head_dim=16, d_ff=64, vocab=256)
SMALL = dict(dtype="bfloat16", n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, head_dim=64, d_ff=512, vocab=512)
_PAIRS = {}
_REF = {}


def _pair(seed=0):
    """(reference model, reference params, port model, port params). JAX is
    imported here, not with the module, so the ``gpu`` cases also run where
    JAX is not installed."""
    if seed not in _PAIRS:
        import jax
        from repro.configs import get_config as jax_get_config
        from repro.models.model import build_model as jax_build_model
        jm = jax_build_model(dataclasses.replace(
            jax_get_config("granite-3-8b", reduced=True), **TINY))
        jp = jm.init(jax.random.PRNGKey(seed))
        tm = build_model(dataclasses.replace(
            get_config("granite-3-8b", reduced=True), **TINY))
        _PAIRS[seed] = (jm, jp, tm, convert.from_jax_params(
            jax.device_get(jp), device="cpu"))
    return _PAIRS[seed]


def _cfg(**over):
    """The reference tests' paged engine (``_paged``/``_spec``)."""
    base = dict(max_len=64, scheduler="continuous", max_slots=2,
                kv_backend="paged", block_size=4,
                quantize_weights="squant", weight_bits=8)
    base.update(over)
    return base


def _spec_cfg(**over):
    return _cfg(**dict(dict(speculative=True, draft_bits=4, draft_k=3),
                       **over))


def _reqs(eos=None):
    """The reference's mixed lengths: 4 requests on 2 slots, two admitted
    mid-flight while residents are mid-decode. ``eos``: request 2's
    per-request EOS override."""
    return [Request([1, 2, 3, 4, 5], 12, request_id=0),
            Request([7, 8, 9, 10, 11, 12, 13, 14, 15], 7, request_id=1),
            Request([3, 1, 4], 15, request_id=2, eos_id=eos),
            Request([9, 9, 8, 7, 6, 5, 4, 3, 2, 1, 2], 4, request_id=3)]


def _port(seed=0, **kw):
    _, _, tm, tp = _pair(seed)
    return ServeEngine(tm, tp, ServeConfig(**kw), device="cpu")


def _tokens(outs):
    return {c.request_id: [int(t) for t in c.tokens] for c in outs}


def _reference(eos=None, **kw):
    """The reference engine's tokens and speculative counters (memoized:
    each configuration is traced and run once per process)."""
    key = (eos, tuple(sorted(kw.items())))
    if key not in _REF:
        from repro.serving import engine as jeng
        jm, jp, _, _ = _pair()
        eng = jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw))
        outs = eng.generate([jeng.Request(list(r.prompt), r.max_new_tokens,
                                          request_id=r.request_id,
                                          eos_id=r.eos_id)
                             for r in _reqs(eos)])
        st = eng.scheduler.stats()
        _REF[key] = (_tokens(outs), {k: st[k] for k in (
            "spec_cycles", "draft_tokens_proposed",
            "draft_tokens_accepted")} if kw.get("speculative") else None)
    return _REF[key]


def _assert_clean(eng):
    kv = eng.scheduler.kv
    kv.check_invariants()
    st = kv.stats()
    assert st["blocks_active"] == 0 and st["blocks_reserved"] == 0


def _check_against_reference(eos=None, **over):
    """Port speculative == reference speculative == port verifier-only, and
    the cycle counters equal the reference's."""
    spec = _spec_cfg(**over)
    want, counters = _reference(eos, **spec)
    eng = _port(**spec)
    eng.on_step = lambda info: eng.scheduler.kv.check_invariants()
    got = _tokens(eng.generate(_reqs(eos)))
    plain = _tokens(_port(**dict(spec, speculative=False)).generate(
        _reqs(eos)))
    assert got == want
    assert got == plain
    st = eng.scheduler.stats()
    assert st["speculative"] and st["spec_cycles"] > 0
    assert {k: st[k] for k in counters} == counters
    _assert_clean(eng)
    return eng, got


# ---------------------------------------------------------------------------
# bit-identity against the reference and against verifier-only decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_k,block_size", [(1, 4), (3, 4), (5, 8)])
def test_speculative_matches_reference_mixed_lengths(draft_k, block_size):
    _check_against_reference(draft_k=draft_k, block_size=block_size)


def test_speculative_fp_target():
    """``quantize_weights=None``: the drafter still quantizes (squant w4)
    and the tokens still equal fp verifier-only decode."""
    eng, _ = _check_against_reference(quantize_weights=None)
    ver = eng.store.current
    assert any(not torch.equal(a, b) for a, b in zip(
        _leaves(ver.draft_params), _leaves(ver.params)))


def test_speculative_with_chunked_admission():
    """prefill_chunk composes: chunked paged admissions run between the
    residents' speculative cycles; the drafter prefills each admitted
    prompt monolithically."""
    eng, _ = _check_against_reference(prefill_chunk=3)
    assert eng.scheduler.stats()["chunk_steps"] > 0


def test_speculative_eos_retirement():
    """A global EOS and a per-request ``eos_id`` override retire at the
    same token with speculation or without, also when the EOS lands inside
    an accepted run."""
    base = _tokens(_port(**_cfg()).generate(_reqs()))
    eos = next(t for t in base[2][:8] if t not in base[0])
    _, got = _check_against_reference(eos_id=eos)
    assert got[2] == base[2][:base[2].index(eos) + 1]
    # the per-request override against the port's verifier-only engine (as
    # the reference's test holds its own two engines)
    eng = _port(**_spec_cfg())
    got = _tokens(eng.generate(_reqs(eos)))
    assert got == _tokens(_port(**_cfg()).generate(_reqs(eos)))
    assert got[2] == base[2][:base[2].index(eos) + 1]
    assert len(got[0]) == 12
    _assert_clean(eng)


def test_completion_and_stats_speculative_counters():
    eng = _port(**_spec_cfg())
    outs = eng.generate(_reqs())
    st = eng.scheduler.stats()
    for c in outs:
        assert 1 <= c.steps <= len(c.tokens)
        assert 0 <= c.draft_tokens_accepted <= c.draft_tokens_proposed
    assert sum(c.draft_tokens_accepted for c in outs) > 0
    assert any(c.steps < len(c.tokens) for c in outs)
    assert st["draft_tokens_accepted"] == \
        sum(c.draft_tokens_accepted for c in outs)
    assert st["draft_tokens_proposed"] == \
        sum(c.draft_tokens_proposed for c in outs)
    assert st["acceptance_rate"] == pytest.approx(
        st["draft_tokens_accepted"] / st["draft_tokens_proposed"])
    assert set(st["accepted_len"]) == {"p50", "p95"}
    assert 1.0 <= st["accepted_len"]["p50"] <= st["accepted_len"]["p95"]
    ref = _port(**_cfg())
    rst = ref.scheduler.stats()
    assert not rst["speculative"] and rst["spec_cycles"] == 0
    for c in ref.generate(_reqs()):
        assert c.steps == len(c.tokens)
        assert c.draft_tokens_proposed == c.draft_tokens_accepted == 0


def test_trace_counts_lazy_keys():
    """Speculative engines add the reference's five keys (all 0 on the
    CPU, which runs eagerly); other engines keep exactly the four."""
    eng = _port(**_spec_cfg())
    eng.generate(_reqs())
    assert eng.trace_counts == dict.fromkeys(
        ("prefill", "prefill_chunk", "decode", "admit", "verify",
         "spec_carry", "draft_prefill", "draft_chain", "draft_admit"), 0)
    ref = _port(**_cfg())
    ref.generate(_reqs())
    assert ref.trace_counts == dict.fromkeys(
        ("prefill", "prefill_chunk", "decode", "admit"), 0)


# ---------------------------------------------------------------------------
# the (target, draft) pair
# ---------------------------------------------------------------------------

def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, QuantizedTensor):
        yield tree.data
        yield tree.scale
    else:
        yield tree


def _qts(tree):
    """QuantizedTensor leaves in sorted-key order (the order of JAX's
    flattening)."""
    if isinstance(tree, dict):
        return [q for k in sorted(tree) for q in _qts(tree[k])]
    if isinstance(tree, list):
        return [q for v in tree for q in _qts(v)]
    return [tree] if isinstance(tree, QuantizedTensor) else []


def test_draft_tree_codes_match_reference():
    """``make_draft_quantize_fn`` at w4, real-quantized: every code and
    scale bit-identical to the reference's drafter tree."""
    import jax
    from repro.quant.qtypes import QuantizedTensor as JaxQT
    from repro.serving import engine as jeng
    from repro.serving.weights import make_draft_quantize_fn as jdraft
    jm, jp, tm, tp = _pair()
    kw = _spec_cfg(dequantize_for_compute=False)
    want = jdraft(jm, jeng.ServeConfig(**kw))(jp)
    got = make_draft_quantize_fn(tm, ServeConfig(**kw), device="cpu")(tp)
    qa = [q for q in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, JaxQT)) if isinstance(q, JaxQT)]
    qb = _qts(got)
    assert len(qa) == len(qb) == 7 * TINY["n_layers"]
    for a, b in zip(qa, qb):
        assert a.bits == b.bits == 4 and tuple(a.shape) == b.shape
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))


def test_weight_store_swaps_target_draft_pair():
    """A different checkpoint staged: BOTH trees of the pair move together,
    the run after the swap serves version 2, and its tokens equal a fresh
    verifier-only engine's on the new weights."""
    eng = _port(**_spec_cfg())
    v1 = eng.store.current
    assert v1.draft_params is not None
    _, _, _, tp2 = _pair(seed=1)
    eng.store.stage(tp2, source="test", block=True)
    assert eng.store.staged_info().version == 2
    outs = eng.generate(_reqs())
    assert all(c.weights_version == 2 for c in outs)
    v2 = eng.store.current
    assert v2.version == 2 and v2.draft_params is not None
    assert not torch.equal(next(_leaves(v2.draft_params)),
                           next(_leaves(v1.draft_params)))
    assert _tokens(outs) == _tokens(_port(seed=1, **_cfg()).generate(
        _reqs()))
    _assert_clean(eng)


def test_weight_store_rejects_draft_without_fp_source():
    """A quantized serving tree cannot rebuild the drafter: the stage fails
    and serving continues on the previous pair."""
    _, _, tm, tp = _pair()
    cfg = ServeConfig(**_spec_cfg())
    store = WeightStore(lambda t: (t, None), tp,
                        draft_quantize_fn=make_draft_quantize_fn(
                            tm, cfg, device="cpu"))
    assert store.current.draft_params is not None
    with pytest.raises(ValueError, match="fp"):
        store.stage(serving_params=tp, source="ckpt", block=True)
    assert store.version == 1
    # an engine refuses a store without a drafter
    with pytest.raises(ValueError, match="draft"):
        ServeEngine(tm, None, cfg, store=WeightStore(serving_params=tp),
                    device="cpu")


# ---------------------------------------------------------------------------
# rewind / ensure_rows (tests/test_kvcache_paged.py's sweep)
# ---------------------------------------------------------------------------

def _advance(kv, params, slots, target):
    """Decode junk tokens until every slot in ``slots`` sits at
    ``target``."""
    tok = torch.zeros((kv.max_slots,), dtype=torch.int32)
    while True:
        active = [i for i in slots if int(kv._lengths[i]) < target]
        if not active:
            return
        kv.decode(params, tok, active)


def test_rewind_sweep_invariants_under_cow_and_pressure():
    """Rewinds of 0..4 tokens at positions around block boundaries, on
    slots whose prompts share a prefix (copy-on-write), in a pool small
    enough for block pressure: the invariants hold after every rewind, and
    a boundary rewound across can be crossed again (the block went back to
    the slot's reservation). ``ensure_rows`` privatizes a shared block in
    a verify's write range."""
    eng = _port(**_cfg(max_len=32, kv_blocks=11))
    kv = eng.scheduler.kv
    sp = eng.store.current.params
    shared = [1, 2, 3, 4, 5, 6]
    kv.admit([(None, Request(shared + [7], 12, request_id=0))], [0], None,
             sp)
    kv.admit([(None, Request(shared + [9], 12, request_id=1))], [1], None,
             sp)
    kv.check_invariants()
    assert kv.stats()["prefix_hits"] >= 1
    for target in (8, 9, 11, 12, 13):
        for n in range(0, 5):
            _advance(kv, sp, (0, 1), target)
            for slot in (0, 1):
                kv.rewind(slot, n)
                kv.check_invariants()
                assert int(kv._lengths[slot]) == target - n
            _advance(kv, sp, (0, 1), target)
            kv.check_invariants()
    kv.retire(0)
    kv.check_invariants()
    kv.admit([(None, Request(shared + [11], 12, request_id=2))], [0], None,
             sp)
    kv.check_invariants()
    # the prefix block is shared with slot 1: a verify write range over it
    # copies it first
    cow = kv.cow_copies
    shared_ph = int(kv._tables[0, 0])
    assert kv._ref[shared_ph] > 1
    kv.ensure_rows(0, 2, 3)
    assert int(kv._tables[0, 0]) != shared_ph and kv.cow_copies == cow + 1
    kv.check_invariants()
    _advance(kv, sp, (0,), 9)
    kv.rewind(0, 2)
    kv.check_invariants()
    kv.rewind(1, 4)
    kv.check_invariants()
    kv.retire(0)
    kv.retire(1)
    kv.check_invariants()
    st = kv.stats()
    assert st["blocks_active"] == 0 and st["blocks_reserved"] == 0


# ---------------------------------------------------------------------------
# the verify forward, row by row
# ---------------------------------------------------------------------------

def _clone(cache):
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone(v) for v in cache]
    return cache.clone() if isinstance(cache, torch.Tensor) else cache


def _filled_pool(model, params, dev, lengths, bs=4, nb=8, seed=0):
    """A paged pool of ``len(lengths)`` slots, slot b holding ``lengths[b]``
    positions decoded from random tokens."""
    b = len(lengths)
    pool = model.init_cache(1 + b * nb, bs, device=dev)
    pool["block_tables"] = torch.arange(
        1, 1 + b * nb, dtype=torch.int32, device=dev).reshape(b, nb)
    g = torch.Generator().manual_seed(seed)
    hist = torch.randint(0, model.cfg.vocab, (b, max(lengths)), generator=g)
    target = torch.tensor(lengths, dtype=torch.int32)
    lens = torch.zeros(b, dtype=torch.int32)
    for t in range(max(lengths)):
        pool["pos"] = torch.minimum(lens, target).to(dev)
        model.decode_step(params, hist[:, t:t + 1].to(dev), pool)
        lens += 1
    return pool


def _rows_vs_decode(model, params, dev, s=4, capture=False):
    """verify_step's (B, S) rows and S decode steps at the same positions
    on two copies of one pool: (verify logits, decode logits, pools)."""
    lengths = [2, 5, 0]
    pool = _filled_pool(model, params, dev, lengths)
    pos = torch.tensor(lengths, dtype=torch.int32, device=dev)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, model.cfg.vocab, (len(lengths), s),
                         generator=g).to(dev)
    vpool = _clone(pool)
    vpool["pos"] = pos.clone()
    if capture:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            model.verify_step(params, toks, _clone(vpool))
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            lg, _ = model.verify_step(params, toks, vpool)
        graph.replay()
    else:
        lg, _ = model.verify_step(params, toks, vpool)
    dec = []
    for j in range(s):
        pool["pos"] = pos + j
        dec.append(model.decode_step(params, toks[:, j:j + 1], pool)[0])
    return lg, torch.stack(dec, dim=1), vpool, pool


@pytest.mark.parametrize("quant", [None, "squant"])
def test_verify_rows_equal_decode_steps(quant):
    """Row (b, j) of ``verify_step`` is bit for bit the logits of a decode
    step at position ``pos[b] + j``, and the pools hold the same K/V after
    (fp and real-quantized w8 weights, float32, on the CPU)."""
    _, _, tm, tp = _pair()
    params = tp if quant is None else quantize_tree(
        tp, method=quant, bits=8, dequantize=False, device="cpu")[0]
    lg, dec, vpool, pool = _rows_vs_decode(tm, params, "cpu")
    assert lg.shape == (3, 4, TINY["vocab"])
    assert torch.equal(lg, dec)
    for a, b in zip(_leaves(vpool["list"]), _leaves(pool["list"])):
        assert torch.equal(a, b)


def test_verify_gates_kept():
    """Verify needs block tables and an fp pool, as in the reference."""
    from repro_torch.models import attention as attn
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              dtype="float32")
    p = attn.init_attention(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
    x = torch.zeros(1, 2, cfg.d_model)
    pos = torch.tensor([0], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="paged KV layout"):
        attn.attention(p, x, cfg=cfg, rope=None, mode="verify",
                       cache={}, pos=pos)
    q = attn.init_kv_cache(2, 4, cfg.n_kv_heads, cfg.head_dim,
                           quantize=True, device="cpu")
    with pytest.raises(NotImplementedError, match="fp KV pool"):
        attn.attention(p, x, cfg=cfg, rope=None, mode="verify", cache=q,
                       pos=pos, block_tables=torch.ones(1, 2,
                                                        dtype=torch.int32))


# ---------------------------------------------------------------------------
# capture bookkeeping on the CPU, with a stand-in graph
# ---------------------------------------------------------------------------

class _Rerun:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    call again on the buffers it was captured on and writes its outputs
    into the static ones, as a graph's kernels would."""

    def __init__(self, run):
        self.run, self.replays = run, 0

    def replay(self):
        self.replays += 1
        self.run()


def _rerun_capture(self, fn, params, batch, caches, out, inputs):
    lg, _ = self._run(fn, params, batch, caches, out)
    static = lg if out is not None else (
        tuple(t.clone() for t in lg) if isinstance(lg, tuple)
        else lg.clone())

    def run():
        new = fn(params, batch, caches)[0]
        if isinstance(static, tuple):
            for a, b in zip(static, new):
                a.copy_(b)
        else:
            static.copy_(new)
    from repro_torch.kernels import ops
    tally = ops.launches_between(ops.launch_counts(), ops.launch_counts())
    return lg, _StepGraph(_Rerun(run), params, inputs, static, tally)


def test_capture_bookkeeping_one_graph_per_width(monkeypatch):
    """On the capture path: one ``verify`` graph per S = k_eff + 1 and one
    ``draft_chain`` graph per k_eff seen, the drafter's prefill and row
    copy and the carry install eager (0); the tokens equal the eager
    engine's; a repeated run captures nothing; a new weight version drops
    the graphs (the chain's hold the draft tree) and captures them again."""
    monkeypatch.setattr(ServeEngine, "_capture", _rerun_capture)

    def make(capture):
        eng = _port(**_spec_cfg())
        eng.capture = capture
        return eng

    cap, eag = make(True), make(False)
    k_seen = []
    run_cycle = cap.scheduler.spec.run_cycle

    def logged(*a):
        out = run_cycle(*a)
        k_seen.append(out[0])
        return out
    cap.scheduler.spec.run_cycle = logged
    got = _tokens(cap.generate(_reqs()))
    assert got == _tokens(eag.generate(_reqs()))
    tc = cap.trace_counts
    ks = set(k_seen)
    assert len(ks) >= 2
    assert tc["verify"] == tc["draft_chain"] == len(ks)
    assert sorted(cap._graphs["verify"]) == sorted((2, k + 1) for k in ks)
    assert sorted(cap._graphs["draft_chain"]) == sorted(cap._graphs[
        "verify"])
    assert tc["decode"] == 0
    assert tc["spec_carry"] == tc["draft_prefill"] == tc["draft_admit"] == 0
    assert eag.trace_counts == dict.fromkeys(tc, 0)
    snap = dict(tc)
    assert _tokens(cap.generate(_reqs())) == got
    assert cap.trace_counts == snap
    cap.store.stage(_pair()[3], source="again", block=True)
    assert _tokens(cap.generate(_reqs())) == got
    assert cap.trace_counts["verify"] == 2 * snap["verify"]
    assert cap.trace_counts["draft_chain"] == 2 * snap["draft_chain"]
    _assert_clean(cap)


# ---------------------------------------------------------------------------
# on the card (gpu)
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _card_model(dev, dims, quant=True):
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **dims)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    if quant:
        params = quantize_tree(params, method="squant", bits=8,
                               dequantize=False, device=dev)[0]
    return model, params


@pytest.mark.gpu
@pytest.mark.parametrize("capture", [False, True], ids=["eager", "captured"])
@pytest.mark.parametrize("dims", [TINY, SMALL], ids=["f32", "bf16"])
def test_card_verify_rows_equal_decode_steps(dev, dims, capture):
    """Through the kernels (B ``tcgemv`` in bf16, ``gemv`` in float32; C
    once per position): every verify row bit-identical to the decode step
    at its position, eager and replayed from a CUDA graph."""
    model, params = _card_model(dev, dims)
    lg, dec, vpool, pool = _rows_vs_decode(model, params, dev,
                                           capture=capture)
    assert torch.isfinite(lg).all()
    assert torch.equal(lg, dec)
    for a, b in zip(_leaves(vpool["list"]), _leaves(pool["list"])):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [TINY, SMALL], ids=["f32", "bf16"])
def test_card_speculative_tokens_equal_verifier_only(dev, dims):
    """A captured speculative engine (w4 drafts, w8 verifier) emits the
    verifier-only engine's tokens; its eager twin the same; the repeat
    captures nothing; graphs per S and per k_eff."""
    model, params = _card_model(dev, dims, quant=False)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, dims["vocab"], size=int(n)).tolist(),
                    int(m), request_id=i)
            for i, (n, m) in enumerate([(9, 12), (17, 7), (5, 15), (30, 6)])]
    kw = dict(max_len=64, scheduler="continuous", max_slots=3,
              kv_backend="paged", block_size=8, prefill_chunk=8,
              quantize_weights="squant", weight_bits=8,
              dequantize_for_compute=False)

    def run(capture, **over):
        eng = ServeEngine(model, params, ServeConfig(**dict(kw, **over)),
                          device=dev, capture=capture)
        return eng, _tokens(eng.generate(reqs))

    _, want = run(True)
    spec, got = run(True, speculative=True, draft_k=3)
    _, eager = run(False, speculative=True, draft_k=3)
    assert got == want == eager
    tc = dict(spec.trace_counts)
    assert tc["verify"] == len(spec._graphs["verify"]) >= 1
    assert tc["draft_chain"] == len(spec._graphs["draft_chain"]) >= 1
    assert tc["draft_prefill"] == tc["draft_admit"] == 0
    spec.generate(reqs)
    assert spec.trace_counts == tc
    spec.scheduler.kv.check_invariants()
