"""The compiled serving step: CUDA graphs over the paged decode step and each
admission-chunk width, with the reference's trace accounting.

On the CPU (every test not marked ``gpu``): the chunk forward with a 0-d
tensor clock is bit-identical to the integer clock and agrees with the JAX
reference's chunk forward; the host keeps the bounds check; the paged decode
reads static buffers that host mutations cannot reach; the launch-counter
bookkeeping of a capture and its replays (a replay's launches read from
its kernels' names); the engine runs eagerly with its counts at 0. On a GPU
(``gpu``): one capture per chunk width and one decode capture, none on a
repeated run, captured tokens equal to the eager path's (fp and int8 KV), a
weight swap recaptures, and the captured run's launches (issued by the
wrappers plus measured in replays) equal the eager run's. Run those with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_step_graphs.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models.model import build_model
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine, _StepGraph

torch.set_num_threads(1)

TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
            head_dim=16, d_ff=64, vocab=256)
MAX_LEN = 32
TOL = dict(rtol=1e-4, atol=1e-4)       # fp32, as tests/test_torch_model.py
_PAIR = {}


def _pair():
    """(reference model, reference params, port model, port params). The
    JAX reference is imported here, not with the module, so the ``gpu``
    cases also run where JAX is not installed."""
    if not _PAIR:
        import jax
        from repro.configs import get_config as jax_get_config
        from repro.models.model import build_model as jax_build_model
        jm = jax_build_model(dataclasses.replace(
            jax_get_config("granite-3-8b", reduced=True), **TINY))
        jp = jm.init(jax.random.PRNGKey(0))
        tm = build_model(dataclasses.replace(
            get_config("granite-3-8b", reduced=True), **TINY))
        _PAIR["v"] = (jm, jp, tm, convert.from_jax_params(
            jax.device_get(jp), device="cpu"))
    return _PAIR["v"]


def _clone(cache):
    """A deep copy of a cache dict (tensors cloned)."""
    if isinstance(cache, dict):
        return {k: _clone(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone(v) for v in cache]
    return cache.clone() if isinstance(cache, torch.Tensor) else cache


def _leaves(cache):
    for period in cache["list"]:
        for blk in sorted(period):
            for name in sorted(period[blk]):
                yield name, period[blk][name]


def _prefixed_cache(tm, tp, quant, offset, seed):
    """A 1-row side cache of MAX_LEN whose first ``offset`` positions hold a
    prefill of random tokens, and those tokens."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, TINY["vocab"], size=(1, offset))
    cache = tm.init_cache(1, MAX_LEN, quantize_kv=quant, device="cpu")
    if offset:
        _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prefix)}, cache)
    cache["pos"] = offset
    return cache, prefix


def _offsets(tm, width):
    return [0, 5, MAX_LEN - tm.chunk_rows(width)]


CASES = [(q, w, o) for q in (False, True) for w in (1, 3, 16)
         for o in range(3)]


def _case_id(c):
    q, w, o = c
    return f"{'int8' if q else 'fp'}-w{w}-{('zero', 'five', 'end')[o]}"


# ---------------------------------------------------------------------------
# the chunk forward's tensor clock
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_chunk_tensor_clock_bit_identical_to_int_clock(case):
    quant, width, which = case
    _, _, tm, tp = _pair()
    offset = _offsets(tm, width)[which]
    base, _ = _prefixed_cache(tm, tp, quant, offset, seed=width)
    toks = torch.from_numpy(np.random.default_rng(7 + width).integers(
        0, TINY["vocab"], size=(1, width)))
    li, ci = tm.prefill_chunk(tp, {"tokens": toks}, _clone(base))
    ct = _clone(base)
    ct["pos"] = torch.tensor(offset, dtype=torch.int64)
    lt, ct = tm.prefill_chunk(tp, {"tokens": toks}, ct)
    assert torch.equal(li, lt)
    assert ci["pos"] == offset + width and int(ct["pos"]) == offset + width
    for (name, a), (_, b) in zip(_leaves(ci), _leaves(ct)):
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_chunk_tensor_clock_matches_reference(case):
    """The port's chunk forward at a tensor clock against the reference's
    chunk forward (its own model, run eagerly on the CPU) on the same
    prefix: last-token logits within fp32 tolerance."""
    quant, width, which = case
    jm, jp, tm, tp = _pair()
    offset = _offsets(tm, width)[which]
    cache, prefix = _prefixed_cache(tm, tp, quant, offset, seed=width)
    cache["pos"] = torch.tensor(offset, dtype=torch.int64)
    chunk = np.random.default_rng(7 + width).integers(
        0, TINY["vocab"], size=(1, width))
    lt, _ = tm.prefill_chunk(tp, {"tokens": torch.from_numpy(chunk)}, cache)
    import jax.numpy as jnp
    jc = jm.init_cache(1, MAX_LEN, quantize_kv=quant)
    if offset:
        _, jc = jm.prefill(jp, {"tokens": jnp.asarray(prefix)}, jc)
    jc = dict(jc, pos=jnp.asarray(offset, jnp.int32))
    jl, _ = jm.prefill_chunk(jp, {"tokens": jnp.asarray(chunk)}, jc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **TOL)


def test_chunk_past_max_len_raises_on_the_host():
    _, _, tm, tp = _pair()
    cache = tm.init_cache(1, MAX_LEN, device="cpu")
    toks = torch.zeros((1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="exceeds"):
        tm.prefill_chunk(tp, {"tokens": toks}, dict(cache, pos=MAX_LEN - 2))
    # a singleton writes two rows (its pad), so it may not start at the end
    with pytest.raises(ValueError, match="exceeds"):
        tm.prefill_chunk(tp, {"tokens": toks[:, :1]},
                         dict(cache, pos=MAX_LEN - 1))
    eng = _paged(tm, tp, prefill_chunk=4)
    kv = eng.scheduler.kv
    with pytest.raises(ValueError, match="exceeds"):
        kv.chunk_inputs(np.zeros(3, np.int64), MAX_LEN - 2)
    with pytest.raises(ValueError, match="exceeds"):
        kv.chunk_inputs(np.zeros(1, np.int64), MAX_LEN - 1)
    buf, clock = kv.chunk_inputs(np.arange(3), MAX_LEN - 3)
    assert buf.tolist() == [[0, 1, 2]] and int(clock) == MAX_LEN - 3
    assert kv.chunk_inputs(np.arange(3), 0)[0] is buf       # one per width


# ---------------------------------------------------------------------------
# the paged decode step's static buffers
# ---------------------------------------------------------------------------

def _paged(tm, tp, capture=True, device="cpu", **kw):
    cfg = dict(max_len=MAX_LEN, scheduler="continuous", max_slots=2,
               kv_backend="paged", block_size=4, weight_bits=8,
               quantize_weights="squant", dequantize_for_compute=False)
    cfg.update(kw)
    return ServeEngine(tm, tp, ServeConfig(**cfg), device=device,
                       capture=capture)


def _reqs():
    return [Request([1, 2, 3, 4, 5, 6], 8, request_id=0),
            Request([7, 8], 3, request_id=1),
            Request([9, 10, 11], 5, request_id=2),
            Request([4, 4, 4, 4], 6, request_id=3),
            Request([9, 8, 7, 6, 5, 4, 3, 2, 1], 4, request_id=4)]


@pytest.mark.parametrize("chunk", [0, 3, 16])
def test_static_buffer_decode_tokens_equal_reference(chunk):
    """The paged decode through its static buffers (and the chunk forwards
    through theirs) gives the reference engine's greedy tokens, as
    ``tests/test_torch_continuous.py`` holds them; the step's inputs and the
    logits buffer keep one identity for the whole run."""
    from repro.serving import engine as jeng
    jm, jp, tm, tp = _pair()
    kw = dict(max_len=MAX_LEN, scheduler="continuous", max_slots=2,
              kv_backend="paged", block_size=4, prefill_chunk=chunk,
              quantize_weights="squant", weight_bits=8,
              dequantize_for_compute=False)
    reqs = _reqs()
    jo = jeng.ServeEngine(jm, jp, jeng.ServeConfig(**kw)).generate(
        [jeng.Request(list(r.prompt), r.max_new_tokens,
                      request_id=r.request_id) for r in reqs])
    eng = _paged(tm, tp, prefill_chunk=chunk)
    kv = eng.scheduler.kv
    seen = set()

    def hook(info):
        seen.add((id(kv.logits), id(kv._cache["pos"]),
                  id(kv._cache["block_tables"]), id(kv._dec_tokens)))
    eng.on_step = hook
    out = eng.generate(reqs)
    assert [c.tokens for c in out] == [[int(t) for t in c.tokens]
                                       for c in jo]
    assert len(seen) == 1
    assert kv._cache["pos"] is kv._dec_pos
    assert kv._cache["block_tables"] is kv._dec_tables
    kv.check_invariants()


def test_host_state_mutated_after_decode_does_not_reach_the_step():
    _, _, tm, tp = _pair()
    eng = _paged(tm, tp)
    kv = eng.scheduler.kv
    tree = eng.store.current.params
    kv.admit([(0, Request([1, 2, 3, 4, 5], 4, request_id=0))], [0], None,
             tree)
    kv.decode(tree, torch.tensor([9, 0], dtype=torch.int32), [0])
    pos, tables = kv._dec_pos.clone(), kv._dec_tables.clone()
    assert pos.tolist() == [5, 0] and kv._lengths.tolist() == [6, 0]
    assert kv._dec_tokens.tolist() == [[9], [0]]
    saved = kv._lengths.copy(), kv._tables.copy()
    kv._lengths[:] = 31
    kv._tables[:] = 7
    assert torch.equal(kv._dec_pos, pos)
    assert torch.equal(kv._dec_tables, tables)
    kv._lengths[:], kv._tables[:] = saved
    kv.retire(0)
    kv.check_invariants()


def test_cpu_engine_runs_eagerly_with_zero_counts():
    _, _, tm, tp = _pair()
    eng = _paged(tm, tp, prefill_chunk=3)
    assert eng.capture is False
    eng.generate(_reqs())
    st = eng.stats()
    assert st["trace_counts"] == {"prefill": 0, "prefill_chunk": 0,
                                  "decode": 0, "admit": 0}
    assert st["graphs"] == {"live": 0, "capture_ms": 0.0, "pool_bytes": 0}
    assert st["scheduler"]["chunk_steps"] > 0


# ---------------------------------------------------------------------------
# launch counters under replay
# ---------------------------------------------------------------------------

def test_capture_tally_added_per_replay():
    """A capture records what the wrappers counted and takes it back (a
    capture runs nothing); a run's launches are what its wrappers issued
    plus each graph's measured replay count times its replays; a rebound
    by-variant dict (as ``chip_smoke.py`` resets it) is followed."""
    saved = ops.launch_counts()
    try:
        dm.launches_by_variant = dict.fromkeys(dm.VARIANTS, 0)
        before = ops.launch_counts()
        dm.launches += 14                       # what a capture counted
        dm.launches_by_variant["tcgemv"] += 14
        pa.launches += 2
        tally = ops.launches_between(before, ops.launch_counts())
        assert tally["dequant_matmul.launches"] == 14
        assert tally["dequant_matmul.launches_by_variant"]["tcgemv"] == 14
        assert tally["paged_attention.launches"] == 2
        assert tally["paged_attention_quant.launches"] == 0
        ops.set_launch_counts(before)
        assert ops.launch_counts() == before
        after = ops.combine_launches(before, tally, 3)
        assert ops.launch_counts() == before    # combining counts nothing
        assert after["dequant_matmul.launches"] == \
            before["dequant_matmul.launches"] + 42
        assert after["dequant_matmul.launches_by_variant"]["tcgemv"] == 42
        assert after["dequant_matmul.launches_by_variant"]["mma"] == 0
        assert after["paged_attention.launches"] == \
            before["paged_attention.launches"] + 6
        assert ops.combine_launches(before, tally, 0) == before
    finally:
        ops.set_launch_counts(saved)


# demangled device-kernel names as torch.profiler reports them, and the
# counter each adds one to (None: a kernel no wrapper counts)
KERNEL_NAMES = [
    ("void (anonymous namespace)::tcgemv_kernel<1, false>(__nv_bfloat16 "
     "const*, signed char const*, float const*, float*, int, int, int)",
     ("dequant_matmul.launches_by_variant", "tcgemv")),
    ("void (anonymous namespace)::pf_kernel<1, false, false>(CUtensorMap_st, "
     "CUtensorMap_st, float const*, __nv_bfloat16*, float*, int, int)",
     ("dequant_matmul.launches_by_variant", "mma")),
    ("void (anonymous namespace)::gemv_kernel<4, 512, false, true>(void "
     "const*, signed char const*, float const*, void*, int, int, int)",
     ("dequant_matmul.launches_by_variant", "gemv")),
    ("void (anonymous namespace)::tiled_kernel<true, false>(void const*, "
     "signed char const*, float const*, void*, int, int, int)",
     ("dequant_matmul.launches_by_variant", "tiled")),
    ("void (anonymous namespace)::paged_decode_split<__nv_bfloat16, "
     "__nv_bfloat16, false, 8, 64, 2, true>(__nv_bfloat16 const*, "
     "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*)",
     ("paged_attention.launches", None)),
    ("void (anonymous namespace)::paged_decode_split<__nv_bfloat16, signed "
     "char, true, 8, 64, 2, true>(__nv_bfloat16 const*, signed char const*, "
     "signed char const*, float const*)",
     ("paged_attention_quant.launches", None)),
    ("void (anonymous namespace)::squant_flip_kernel<true>((anonymous "
     "namespace)::FlipArgs)", ("squant_flip.launches_by_route", "cp16")),
    ("void (anonymous namespace)::squant_flip_kernel<false>((anonymous "
     "namespace)::FlipArgs)", ("squant_flip.launches_by_route", "cp4")),
    ("void (anonymous namespace)::squant_scale_kernel<true>((anonymous "
     "namespace)::ScaleArgs)", ("squant_flip.scale_launches", None)),
    ("(anonymous namespace)::tcgemv_merge(float const*, __nv_bfloat16*, "
     "int, int, int)", None),
    ("void (anonymous namespace)::paged_decode_merge<__nv_bfloat16>(float "
     "const*, float const*, __nv_bfloat16*, int, int)", None),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_"
     "impl_nocast<at::native::direct_copy_kernel_cuda(at::TensorIterator&)"
     "::{lambda()#3}::operator()() const>(at::TensorIteratorBase&)>(int, "
     "at::native::gpu_kernel_impl_nocast)", None),
    ("Memcpy HtoD (Pinned -> Device)", None),
]


@pytest.mark.parametrize("name,counter", KERNEL_NAMES,
                         ids=[f"k{i}" for i in range(len(KERNEL_NAMES))])
def test_count_kernels_by_symbol(name, counter):
    """A replay's kernels, read by name, count as their wrapper counts a
    call: one per primary kernel (B's variant from its symbol, C or D from
    the split pass's QUANT argument, A's route from V16), none for a merge
    pass or a PyTorch kernel."""
    zero = ops.count_kernels([])
    got = ops.count_kernels([name, name])
    if counter is None:
        assert got == zero
        return
    key, sub = counter
    want = {k: (dict(v) if isinstance(v, dict) else v)
            for k, v in zero.items()}
    if sub is None:
        want[key] += 2
    else:
        want[key][sub] += 2
        want[key.split(".")[0] + ".launches"] += 2
    assert got == want


# mangled names as the driver gives a graph's kernel nodes (the kernels'
# signatures, cut short), and the counter each adds one to
MANGLED = [
    ("_ZN12_GLOBAL__N_113tcgemv_kernelILi1ELb0EEEvPK13__nv_bfloat16PKaPKfPfi",
     ("dequant_matmul.launches_by_variant", "tcgemv")),
    ("_ZN12_GLOBAL__N_19pf_kernelILi1ELb0ELb0EEEv14CUtensorMap_stS1_PKfP13"
     "__nv_bfloat16", ("dequant_matmul.launches_by_variant", "mma")),
    ("_ZN12_GLOBAL__N_118paged_decode_splitI13__nv_bfloat16S1_Lb0ELi8ELi64E"
     "Li2ELb1EEEvPKT_PKT0_S7_PKf", ("paged_attention.launches", None)),
    ("_ZN12_GLOBAL__N_118paged_decode_splitI13__nv_bfloat16aLb1ELi8ELi64ELi2"
     "ELb1EEEvPKT_PKT0_S7_PKf", ("paged_attention_quant.launches", None)),
    ("_ZN12_GLOBAL__N_112tcgemv_mergeEPKfP13__nv_bfloat16i", None),
]


@pytest.mark.parametrize("name,counter", MANGLED,
                         ids=[f"m{i}" for i in range(len(MANGLED))])
def test_graph_node_names_demangle_to_their_counter(name, counter):
    """A graph node's mangled kernel name, demangled as the profiler shows
    it, counts where the kernel's wrapper counts a call."""
    got = ops.count_kernels([ops._demangle(name.encode())])
    zero = ops.count_kernels([])
    if counter is None:
        assert got == zero
        return
    key, sub = counter
    if sub is None:
        assert got == dict(zero, **{key: 1})
    else:
        assert got[key][sub] == 1 and sum(got[key].values()) == 1
        assert got[key.split(".")[0] + ".launches"] == 1


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_step_graph_replay_counts_and_refuses_other_tensors():
    """The holder counts its replays and touches no launch counter (its
    kernels launch without their wrappers), and refuses to replay on other
    weights or buffers than it was captured on (a stale graph would read
    freed or outgoing weights)."""
    params = {"w": torch.zeros(2)}
    inputs = (torch.zeros(2, 1), torch.zeros(2), None, torch.zeros(3),
              torch.zeros(2, 4))
    tally = ops.launches_between(ops.launch_counts(), ops.launch_counts())
    tally["paged_attention.launches"] = 3
    g = _StepGraph(_FakeGraph(), params, inputs, inputs[4], tally)
    n0 = ops.launch_counts()
    assert g.replay(params, inputs) is inputs[4]
    assert g.graph.replays == g.replays == 1
    assert ops.launch_counts() == n0
    with pytest.raises(RuntimeError, match="captured on"):
        g.replay(dict(params), inputs)
    with pytest.raises(RuntimeError, match="captured on"):
        g.replay(params, inputs[:3] + (torch.zeros(3),) + inputs[4:])
    assert g.graph.replays == g.replays == 1


def test_replay_launches_measured_per_graph(monkeypatch):
    """``ServeEngine.replay_launches``: each live graph's measured replay
    count (here a stand-in for its kernel nodes) times its replays, summed;
    a measured count other than its capture's tally raises."""
    _, _, tm, tp = _pair()
    eng = _paged(tm, tp)
    zero = ops.count_kernels([])
    ta = ops.combine_launches(zero, dict(zero, **{
        "paged_attention.launches": 2, "dequant_matmul.launches": 14,
        "dequant_matmul.launches_by_variant": {"tcgemv": 14}}))
    tb = ops.combine_launches(zero, dict(zero, **{
        "dequant_matmul.launches": 14,
        "dequant_matmul.launches_by_variant": {"mma": 14}}))
    ga = _StepGraph(_FakeGraph(), None, (), None, ta)
    gb = _StepGraph(_FakeGraph(), None, (), None, tb)
    ga.replays, gb.replays = 5, 2
    eng._graphs = {"decode": {(2, 1): ga}, "prefill_chunk": {(1, 64): gb}}
    measured = {id(ga.graph): ta, id(gb.graph): tb}
    monkeypatch.setattr(ops, "graph_launches", lambda g: measured[id(g)])
    got = eng.replay_launches()
    assert got["dequant_matmul.launches"] == 14 * 7
    assert got["dequant_matmul.launches_by_variant"] == \
        {"gemv": 0, "tiled": 0, "tcgemv": 70, "mma": 28}
    assert got["paged_attention.launches"] == 10
    assert ga.replays == 5 and gb.replays == 2       # nothing was replayed
    measured[id(gb.graph)] = ta
    with pytest.raises(RuntimeError, match="its capture counted"):
        eng.replay_launches()


# ---------------------------------------------------------------------------
# the engine's capture bookkeeping on the CPU, with a stand-in graph
# ---------------------------------------------------------------------------

class _Rerun:
    """Stands in for a CUDA graph on the CPU: a replay runs the captured
    call again on the buffers it was captured on and writes its logits
    into the static output, as a graph's kernels would."""

    def __init__(self, run):
        self.run, self.replays = run, 0

    def replay(self):
        self.replays += 1
        self.run()


def _rerun_capture(self, fn, params, batch, caches, out, inputs):
    lg, _ = self._run(fn, params, batch, caches, out)
    static = lg if out is not None else lg.clone()

    def run():
        static.copy_(fn(params, batch, caches)[0])
    tally = ops.launches_between(ops.launch_counts(), ops.launch_counts())
    return lg, _StepGraph(_Rerun(run), params, inputs, static, tally)


@pytest.fixture
def rerun_graphs(monkeypatch):
    """Engines made through it take the capture path on the CPU, with
    :class:`_Rerun` in place of ``torch.cuda.CUDAGraph``."""
    monkeypatch.setattr(ServeEngine, "_capture", _rerun_capture)

    def make(*a, **kw):
        eng = _paged(*a, **kw)
        eng.capture = kw.get("capture", True)
        return eng
    return make


def test_capture_bookkeeping_one_per_width(rerun_graphs):
    """The reference's trace test (``tests/test_paged_chunked.py``) on the
    engine's capture path: one ``prefill_chunk`` capture per distinct width,
    one decode capture, nothing for the eager entry points, a repeated run
    of the same shapes adds none, and the tokens are the eager engine's."""
    _, _, tm, tp = _pair()
    reqs = [Request([11, 12, 13, 14, 15, 16, 17], 3, request_id=0),
            Request([21, 22, 23, 24, 25], 3, request_id=1)]
    eng = rerun_graphs(tm, tp, prefill_chunk=3)
    decode, calls = eng._decode, []
    eng._decode = lambda *a, **kw: calls.append(1) or decode(*a, **kw)
    out = eng.generate(reqs)
    tc = eng.trace_counts
    # widths: 7 -> 3,3,1; 5 -> 3,2  => {3, 2, 1}
    assert tc == {"prefill": 0, "prefill_chunk": 3, "decode": 1, "admit": 0}
    assert eng.scheduler.stats()["chunk_steps"] == 3 + 2
    graphs = eng._graphs
    assert sorted(graphs["prefill_chunk"]) == [(1, 1), (1, 2), (1, 3)]
    assert list(graphs["decode"]) == [(2, 1)]
    assert graphs["decode"][(2, 1)].graph.replays == len(calls) - 1 > 0
    eager = rerun_graphs(tm, tp, prefill_chunk=3, capture=False)
    assert [c.tokens for c in out] == [c.tokens for c in eager.generate(reqs)]
    assert eager.trace_counts == dict.fromkeys(tc, 0)
    eng.generate(reqs)
    snap = dict(eng.trace_counts)
    again = eng.generate(reqs)
    assert eng.trace_counts == snap
    assert [c.tokens for c in again] == [c.tokens for c in out]
    eng.scheduler.kv.check_invariants()


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("quant_kv", [False, True], ids=["fp_kv", "int8_kv"])
def test_capture_path_tokens_equal_eager(rerun_graphs, quant_kv, chunk):
    _, _, tm, tp = _pair()
    kw = dict(prefill_chunk=chunk, quantize_kv=quant_kv, max_slots=3)
    cap = rerun_graphs(tm, tp, **kw)
    got = [c.tokens for c in cap.generate(_reqs())]
    want = [c.tokens for c in rerun_graphs(tm, tp, capture=False,
                                           **kw).generate(_reqs())]
    assert got == want
    assert cap.trace_counts["decode"] == 1
    assert cap.trace_counts["prefill_chunk"] == len(cap._graphs[
        "prefill_chunk"]) >= 1


def test_weight_swap_drops_and_recaptures(rerun_graphs):
    """A second version of the same weights staged mid-run (quantized
    again: new tensors, equal values) drops every graph at the swap; the
    next steps capture again and count it, and the tokens are the eager
    engine's under the same swap. Without the drop the first replay on the
    new weights raises (the holder's check)."""
    _, _, tm, tp = _pair()
    reqs = [Request([1, 2, 3, 4, 5], 6, request_id=0),
            Request([6, 7, 8], 9, request_id=1),
            Request([9, 10, 11, 12], 5, request_id=2),
            Request([2, 4, 6, 8, 10, 12], 4, request_id=3)]

    def run(capture, drop=True):
        eng = rerun_graphs(tm, tp, capture=capture, prefill_chunk=2,
                           swap_deadline_ms=None)
        if not drop:
            eng._drop_graphs = lambda *names: None

        def hook(info):
            if info["step"] == 4 and eng.store.version == 1 \
                    and not eng.store.staged_pending:
                eng.store.stage(fp_params=tp, source="again", block=True)
        eng.on_step = hook
        out = eng.generate(reqs)
        return eng, [c.tokens for c in out], \
            [c.weights_version for c in out]

    cap, tc, vc = run(True)
    eag, te, ve = run(False)
    assert tc == te and vc == ve and vc[0] == 1 and max(vc) == 2
    assert cap.stats()["weights"]["swaps"] == 1
    assert cap.trace_counts["decode"] == 2
    # the widths used after the swap were captured a second time
    assert cap.trace_counts["prefill_chunk"] > \
        len(cap._graphs["prefill_chunk"]) >= 1
    with pytest.raises(RuntimeError, match="captured on"):
        run(True, drop=False)


# ---------------------------------------------------------------------------
# on the card (gpu): captures, replays, swaps
# ---------------------------------------------------------------------------

SMALL = dict(dtype="bfloat16", n_layers=2, d_model=256, n_heads=4,
             n_kv_heads=2, head_dim=64, d_ff=512, vocab=512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    return torch.device("cuda", 0)


def _card_model(dev, dims):
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **dims)
    model = build_model(cfg)
    return model, model.init(torch.Generator(device=dev).manual_seed(0),
                             device=dev)


def _card_reqs(vocab, n=6, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=9).tolist()
    return [Request(shared + rng.integers(0, vocab, size=int(
        rng.integers(2, 30))).tolist(), int(rng.integers(3, 9)),
        request_id=i) for i in range(n)]


def _card_run(model, params, dev, capture, reqs, **kw):
    """(engine, tokens, launches of the run, chunk widths it used)."""
    cfg = dict(max_len=64, max_slots=3, block_size=8)
    cfg.update(kw)
    eng = _paged(model, params, capture=capture, device=dev, **cfg)
    widths = set()
    chunk_fn = eng._prefill_chunk

    def chunk(params, batch, caches, out=None):
        widths.add(batch["tokens"].shape[1])
        return chunk_fn(params, batch, caches, out)
    eng._prefill_chunk = chunk
    counts0 = ops.launch_counts()
    out = eng.generate(reqs)
    torch.cuda.synchronize()
    # what the wrappers issued, plus what the replays launched, measured
    # per graph on the card (each checked against its capture's tally)
    issued = ops.launches_between(counts0, ops.launch_counts())
    return eng, [c.tokens for c in out], \
        ops.combine_launches(issued, eng.replay_launches()), widths


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [TINY, SMALL], ids=["f32", "bf16"])
def test_card_one_capture_per_chunk_width(dev, dims):
    """The port's twin of ``tests/test_paged_chunked.py``'s trace test: one
    ``prefill_chunk`` capture per distinct width (a singleton is its own
    width though it pads to two rows), one decode capture, no monolithic
    prefill, and a repeated same-shape run adds no capture."""
    model, params = _card_model(dev, dims)
    reqs = [Request([11, 12, 13, 14, 15, 16, 17], 3, request_id=0),
            Request([21, 22, 23, 24, 25], 3, request_id=1)]
    eng = _paged(model, params, device=dev, max_len=64, block_size=8,
                 prefill_chunk=3)
    eng.generate(reqs)
    tc = eng.trace_counts
    # widths: 7 -> 3,3,1; 5 -> 3,2  => {3, 2, 1}
    assert tc == {"prefill": 0, "prefill_chunk": 3, "decode": 1, "admit": 0}
    assert eng.scheduler.stats()["chunk_steps"] == 3 + 2
    st = eng.stats()["graphs"]
    assert st["live"] == 4 and st["capture_ms"] > 0 and st["pool_bytes"] > 0
    eng.generate(reqs)
    snap = dict(eng.trace_counts)
    eng.generate(reqs)
    assert eng.trace_counts == snap
    eng.scheduler.kv.check_invariants()


@pytest.mark.gpu
@pytest.mark.parametrize("quant_kv", [False, True], ids=["fp_kv", "int8_kv"])
@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("dims", [TINY, SMALL], ids=["f32", "bf16"])
def test_card_captured_tokens_and_launches_equal_eager(dev, dims, chunk,
                                                       quant_kv):
    model, params = _card_model(dev, dims)
    reqs = _card_reqs(dims["vocab"])
    kw = dict(prefill_chunk=chunk, quantize_kv=quant_kv)
    cap, tc, lc, widths = _card_run(model, params, dev, True, reqs, **kw)
    eag, te, le, _ = _card_run(model, params, dev, False, reqs, **kw)
    assert tc == te
    assert lc == le and lc["dequant_matmul.launches"] > 0
    key = "paged_attention_quant" if quant_kv else "paged_attention"
    assert lc[f"{key}.launches"] > 0
    assert cap.trace_counts["decode"] == 1
    assert cap.trace_counts["prefill_chunk"] == len(widths) >= 1
    assert eag.trace_counts == dict.fromkeys(eag.trace_counts, 0)


@pytest.mark.gpu
def test_card_weight_swap_recaptures(dev):
    """A second version of the same tree (the fp weights quantized again:
    new addresses, same values) staged mid-run: the swap drops every graph,
    the next steps capture again and count it, and the tokens equal the
    eager engine's under the same swap."""
    model, params = _card_model(dev, SMALL)
    reqs = _card_reqs(SMALL["vocab"], n=5, seed=1)

    def run(capture):
        eng = _paged(model, params, capture=capture, device=dev, max_len=64,
                     max_slots=2, block_size=8, prefill_chunk=4,
                     swap_deadline_ms=None)

        def hook(info):
            if info["step"] == 6 and eng.store.version == 1 \
                    and not eng.store.staged_pending:
                eng.store.stage(fp_params=params, source="again",
                                block=True)
        eng.on_step = hook
        out = eng.generate(reqs)
        return eng, [c.tokens for c in out], \
            [c.weights_version for c in out]

    cap, tc, vc = run(True)
    eag, te, ve = run(False)
    assert tc == te and vc == ve and max(vc) == 2
    assert cap.stats()["weights"]["swaps"] == 1
    assert cap.trace_counts["decode"] == 2
    assert cap.trace_counts["prefill_chunk"] >= 2


# kernel B's symbols with the (M, N) a graph node's arguments give, and the
# by-shape key each counts under
SHAPED = [
    ("void (anonymous namespace)::tcgemv_kernel<1, false>(__nv_bfloat16 "
     "const*, signed char const*, float const*, float*, int, int, int)",
     (1408, 2048), "tcgemv 1408x2048"),
    ("void (anonymous namespace)::pf_kernel<1, false, false>(CUtensorMap_st, "
     "CUtensorMap_st, float const*, __nv_bfloat16*, float*, int, int)",
     (2048, 1408), "mma 2048x1408"),
    ("void (anonymous namespace)::gemv_kernel<4, 512, false, true>(void "
     "const*, signed char const*, float const*, void*, int, int, int)",
     (128, 256), "gemv 128x256"),
    ("void (anonymous namespace)::tiled_kernel<true, false>(void const*, "
     "signed char const*, float const*, void*, int, int, int)",
     (256, 128), "tiled 256x128"),
]


@pytest.mark.parametrize("name,mn,key", SHAPED,
                         ids=[k.split()[0] for _, _, k in SHAPED])
def test_count_kernels_by_shape(name, mn, key):
    """A kernel-B node read with its (M, N) counts under its variant and
    its weight shape, as the wrapper counts the call; a bare name counts
    its variant only; no other key of the by-shape counter appears."""
    got = ops.count_kernels([(name, mn), (name, mn), name])
    assert got["dequant_matmul.launches"] == 3
    assert got["dequant_matmul.launches_by_variant"][key.split()[0]] == 3
    assert got["dequant_matmul.launches_by_shape"] == {key: 2}
    assert ops.count_kernels([])["dequant_matmul.launches_by_shape"] == {}


def test_by_shape_counts_combine_without_zero_keys():
    """The by-shape counter has no fixed keys: combining and differencing
    counts add keys as they are counted and drop the ones that come to 0,
    so a run's launches compare equal however the counters were reset in
    between; the by-variant counter keeps all its keys."""
    zero = ops.count_kernels([])
    a = ops.combine_launches(zero, dict(zero, **{
        "dequant_matmul.launches": 3,
        "dequant_matmul.launches_by_variant": {"tcgemv": 3},
        "dequant_matmul.launches_by_shape": {"tcgemv 8x16": 2,
                                             "tcgemv 16x8": 1}}))
    assert a["dequant_matmul.launches_by_shape"] == {"tcgemv 8x16": 2,
                                                     "tcgemv 16x8": 1}
    b = ops.combine_launches(a, a, 2)
    assert b["dequant_matmul.launches_by_shape"] == {"tcgemv 8x16": 6,
                                                     "tcgemv 16x8": 3}
    back = ops.launches_between(a, a)
    assert back["dequant_matmul.launches_by_shape"] == {}
    assert back["dequant_matmul.launches_by_variant"] == \
        dict.fromkeys(dm.VARIANTS, 0)
    assert back == zero
