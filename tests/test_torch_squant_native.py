"""Kernel A on (in, out) leaves where they are stored, on the CPU: the plain
version of the native-layout entry point and the pipeline's native route
against the JAX pipeline, the bucket planner, a NumPy transcription of the
kernel (its staging of input rows, its lane -> element mapping, its order of
summation and its arg-max rounds) against the first port's order and the
plain version, and the scale pass's formula against ``_scales`` and the JAX
pipeline's jitted scales."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.quant.qtypes import QuantizedTensor as JaxQT
from repro_torch.core import pipeline
from repro_torch.core.dispatch import _scales, quantize_codes_native
from repro_torch.core.squant import squant_codes
from repro_torch.kernels import _build
from repro_torch.kernels import ops
from repro_torch.kernels import squant_flip as sf
from repro_torch.quant.qtypes import QuantizedTensor

from conftest import grid_weights

torch.set_num_threads(1)

CU = os.path.join(_build.CSRC, "squant_flip.cu")
F32 = np.float32
FULL = 0xFFFFFFFF


def _cu_constants():
    src = open(CU).read()
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        expr = " ".join(expr.split()).replace("/", "//")   # C++ int division
        env[name] = eval(expr, {}, dict(env))
    return env


CUC = _cu_constants()
TC, SLAB, NSTAGE = CUC["TC"], CUC["SLAB"], CUC["NSTAGE"]
ROW_BYTES, BLK, STAGE_BYTES = CUC["ROW_BYTES"], CUC["BLK"], CUC["STAGE_BYTES"]


# ---------------------------------------------------------------------------
# the native route against the JAX pipeline
# ---------------------------------------------------------------------------

def _dense_tree(rng, exact):
    """(in, out) leaves: two sharing a bucket, a ragged ``in`` (300, not a
    multiple of 128), odd ``out`` (33, 7), a whole-row leaf (in < 128), an
    expert bank (native route: each expert's slice read as a leaf) and a
    conv kernel (stacked route)."""
    def w(*shape):
        if exact:
            return grid_weights(rng, int(np.prod(shape[:-1])),
                                shape[-1]).reshape(shape)
        return rng.normal(size=shape).astype(np.float32)
    return {"l0": {"w": w(256, 32)}, "l1": {"w": w(256, 32)},
            "rag": {"w": w(300, 33)}, "odd": {"w": w(200, 7)},
            "head": {"w": w(48, 16)}, "moe": {"w": w(2, 256, 8)},
            "conv": {"w_conv": w(3, 3, 4, 8)}}


def _qts(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _qts(tree[k], path + (k,))
        return out
    return [(path, tree)] if isinstance(tree, QuantizedTensor) else []


def _jax_qts(tree):
    import jax
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JaxQT))
    return [l for l in leaves if isinstance(l, JaxQT)]


def _force_native(monkeypatch):
    """Plan as on a CUDA device under the kernel backend; the wrappers then
    take their plain versions because the tensors lie on the CPU."""
    real = pipeline.plan_buckets
    monkeypatch.setattr(pipeline, "plan_buckets",
                        lambda leaves, m, g, native, **kw:
                        real(leaves, m, g, True, **kw))


@pytest.mark.parametrize("method", pipeline.METHODS)
@pytest.mark.parametrize("bits", [4, 8])
def test_native_route_equals_reference_on_exact_inputs(rng, monkeypatch,
                                                       method, bits):
    src = _dense_tree(rng, exact=True)
    tj, rj = jax_quantize_tree({k: {n: jnp.asarray(a) for n, a in v.items()}
                                for k, v in src.items()}, method=method,
                               bits=bits, group_size=128, backend="ref")
    _force_native(monkeypatch)
    tt, rt = pipeline.quantize_tree(
        {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
         for k, v in src.items()}, method=method, bits=bits, group_size=128,
        device="cpu")
    qa, qb = _jax_qts(tj), _qts(tt)
    assert len(qa) == len(qb) == 7
    for a, (path, b) in zip(qa, qb):
        assert tuple(a.shape) == b.shape, path
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    assert [b.key for b in rt.buckets] == [b.key for b in rj.buckets]
    native = {b.key for b in rt.buckets if b.route == "native"}
    if method in ("squant", "squant_e", "squant_ek"):
        assert native == {"(32,256)x2 float32 g128", "(33,300)x1 float32 g128",
                          "(7,200)x1 float32 g128",
                          "(16,256)x1 float32 g128"}
    else:
        assert native == set()


@pytest.mark.parametrize("method", ["squant", "squant_e", "squant_ek"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("kin,nch,g", [(300, 33, 128), (1001, 7, 64),
                                       (130, 16, 12)])
@pytest.mark.parametrize("scale_method", ["max", "mse"])
def test_native_entry_plain_equals_stacked_dispatch(rng, method, bits, kin,
                                                    nch, g, scale_method):
    """``quantize_codes_native`` on the CPU (the plain versions of the two
    kernels) gives the stacked route's codes and scales bit for bit."""
    from repro_torch.core.dispatch import quantize_codes_batched
    leaves = [torch.from_numpy(grid_weights(rng, kin, nch)) for _ in range(3)]
    codes, scales = quantize_codes_native(leaves, method=method, bits=bits,
                                          group_size=g,
                                          scale_method=scale_method,
                                          backend="ref")
    want_c, want_s = quantize_codes_batched(
        torch.stack([l.T for l in leaves]), method=method, bits=bits,
        group_size=g, scale_method=scale_method, backend="ref")
    assert codes.shape == (3, nch, kin) and scales.shape == (3, nch, 1)
    assert torch.equal(codes, want_c) and torch.equal(scales, want_s)


def test_native_route_on_random_inputs_close_to_reference(rng, monkeypatch):
    src = _dense_tree(rng, exact=False)
    tj, _ = jax_quantize_tree({k: {n: jnp.asarray(a) for n, a in v.items()}
                               for k, v in src.items()}, bits=8,
                              group_size=128, backend="ref")
    _force_native(monkeypatch)
    tt, _ = pipeline.quantize_tree(
        {k: {n: torch.from_numpy(a.copy()) for n, a in v.items()}
         for k, v in src.items()}, bits=8, group_size=128, device="cpu")
    differing = 0
    for a, (_, b) in zip(_jax_qts(tj), _qts(tt)):
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        diff = b.codes().numpy().astype(int) - np.asarray(a.codes()).astype(int)
        assert np.abs(diff).max() <= 1
        differing += int((diff != 0).any(axis=tuple(range(1, diff.ndim))).sum())
    assert differing <= 2, differing


def test_native_wrappers_take_the_plain_version_on_the_cpu(rng):
    leaves = [torch.from_numpy(grid_weights(rng, 256, 8)) for _ in range(2)]
    n0, s0 = sf.launches, sf.scale_launches
    s = ops.squant_scales(leaves, 8)
    codes = ops.squant_flip_leaves(leaves, s, bits=8, group_size=128)
    assert (sf.launches, sf.scale_launches) == (n0, s0)
    assert codes.shape == (2, 8, 256) and s.shape == (2, 8)
    with pytest.raises(ValueError):
        ops.squant_flip_leaves(leaves, s, bits=8, group_size=128,
                               backend="cuda")


# ---------------------------------------------------------------------------
# the bucket planner: a pure function of shapes
# ---------------------------------------------------------------------------

def _granite_leaves(layers=40, d=4096, ff=12800, kv=1024):
    per_layer = [(d, d), (d, kv), (d, kv), (d, d), (d, ff), (d, ff), (ff, d)]
    return [(s, "float32", 4, True) for _ in range(layers) for s in per_layer]


def test_planner_granite_full_width_one_launch_per_bucket():
    leaves = _granite_leaves()
    plans = pipeline.plan_buckets(leaves, "squant", 128, native=True)
    assert [(p.key, len(p.entries), p.route, len(p.chunks)) for p in plans] \
        == [(((4096, 4096), "float32", 128), 80, "native", 1),
            (((1024, 4096), "float32", 128), 80, "native", 1),
            (((12800, 4096), "float32", 128), 80, "native", 1),
            (((4096, 12800), "float32", 128), 40, "native", 1)]
    # the stacked route (the CPU, or the plain backend) chunks at 1 GB
    stacked = pipeline.plan_buckets(leaves, "squant", 128, native=False)
    assert all(p.route == "stacked" for p in stacked)
    assert [len(p.chunks) for p in stacked] == [5, 2, 16, 8]    # 31


@pytest.mark.parametrize("method", pipeline.METHODS)
def test_planner_routes_by_leaf_and_method(method):
    leaves = [((256, 32), "float32", 4, True),      # 0 native
              ((256, 32), "float32", 4, True),      # 1 same bucket
              ((300, 33), "float32", 4, True),      # 2 native, odd out
              ((48, 16), "float32", 4, True),       # 3 whole row: no kernel
              ((2, 256, 8), "float32", 4, True),    # 4 expert bank, native
              ((3, 3, 4, 8), "float32", 4, True),   # 5 conv
              ((256, 64), "bfloat16", 2, True),     # 6 not float32
              ((256, 40), "float32", 4, False)]     # 7 not contiguous
    plans = pipeline.plan_buckets(leaves, method, 128, native=True)
    routes = {tuple(p.entries): p.route for p in plans}
    kernel = method in ("squant", "squant_e", "squant_ek")
    want = {(0, 1): "native" if kernel else "stacked",
            (2,): "native" if kernel else "stacked",
            (3,): "stacked", (4,): "native" if kernel else "stacked",
            (5,): "stacked",
            (6,): "stacked", (7,): "stacked"}
    assert routes == want
    assert all(len(p.chunks) == 1 for p in plans)


def test_planner_native_bucket_never_chunks():
    leaves = [((4096, 12800), "float32", 4, True)] * 12     # 2.5 GB
    (plan,) = pipeline.plan_buckets(leaves, "squant", 128, native=True)
    assert plan.route == "native" and plan.chunks == [list(range(12))]
    (plan,) = pipeline.plan_buckets(leaves, "squant", 128, native=False)
    assert [len(c) for c in plan.chunks] == [5, 5, 2]
    many = [((256, 8), "float32", 4, True)] * (sf.MAX_LEAVES + 1)
    (plan,) = pipeline.plan_buckets(many, "squant", 128, native=True)
    assert plan.route == "native" and len(plan.chunks) == 1


def test_planner_keeps_mixed_buckets_whole():
    """A bucket in which one leaf cannot take the native route takes the
    stacked route as a whole, so bucket keys stay those of the reference."""
    leaves = [((256, 32), "float32", 4, True), ((256, 32), "float32", 4, False)]
    (plan,) = pipeline.plan_buckets(leaves, "squant", 128, native=True)
    assert plan.route == "stacked" and plan.entries == [0, 1]


def test_route_rule():
    assert sf.route(4096, True) == "cp16"
    assert sf.route(33, True) == "cp4"
    assert sf.route(4096, False) == "cp4"


# ---------------------------------------------------------------------------
# the kernel transcribed: staging, lane -> element mapping, sums, rounds
# ---------------------------------------------------------------------------

def _row_off(r):
    return (r >> 2) * BLK + (r & 3) * ROW_BYTES


def test_cu_constants_and_shared_memory_budget():
    assert (TC, SLAB, ROW_BYTES, BLK) == (32, sf.MAX_GROUP, 128, 528)
    assert CUC["MAX_LEAVES"] == sf.MAX_LEAVES
    ring = CUC["BAR_BYTES"] + NSTAGE * STAGE_BYTES
    summ = TC * CUC["SUMM_BYTES"]                  # a group's summaries
    assert 2 * (ring + CUC["NG_SMEM"] * summ + 1024) <= 228 * 1024
    # three CTAs an SM (the launch bound) up to in = 12800 at g = 128
    assert 3 * (ring + 100 * summ + 1024) <= 228 * 1024
    assert CUC["BAR_BYTES"] >= 2 * NSTAGE * 8
    # every staged row is a 16-byte aligned segment of its own in the stage
    offs = [_row_off(r) for r in range(SLAB)]
    assert all(o % 16 == 0 for o in offs)
    assert all(b - a >= ROW_BYTES for a, b in zip(offs, offs[1:]))
    assert offs[-1] + ROW_BYTES <= STAGE_BYTES


@pytest.mark.parametrize("g", [128, 64, 12, 9, 1])
def test_staged_reads_are_free_of_bank_conflicts(g):
    """Lane l of warp w reads 16 bytes at row ro + 4l + j, channel 4w: in
    each quarter warp the eight reads start in distinct 16-byte units mod 8
    (the 32 banks), for every group offset ``ro`` a stage gives."""
    gps = SLAB // g
    for ro in range(0, gps * g, g):
        for w in range(TC // 4):
            for j in range(4):
                for q in range(4):
                    lanes = [l for l in range(8 * q, 8 * q + 8)
                             if 4 * l + j < g]
                    units = {((_row_off(ro + 4 * l + j) + 16 * w) // 16) % 8
                             for l in lanes}
                    assert len(units) == len(lanes)


def _stage(x, sc, sk, c0, k0, rows, nch):
    """The producer: rows k0..k0+rows-1 of channels c0..c0+31 of the matrix
    ``x`` (flat, element (c, k) at c*sc + k*sk) into a stage, as 32-bit
    words at byte offset row_off(r) + 4*c."""
    st = np.full(STAGE_BYTES // 4, np.nan, F32)
    for r in range(rows):
        for c in range(min(TC, nch - c0)):
            st[(_row_off(r) + 4 * c) // 4] = x[(c0 + c) * sc + (k0 + r) * sk]
    return st


def _lane_elements(st, w, ro, g, kb, kin):
    """What lane l of consumer warp w holds for channel 4w+i, element j:
    the float4 at row ro + 4l + j (masked past the group and the input)."""
    out = np.zeros((4, 32, 4), F32)
    for l in range(32):
        for j in range(4):
            idx = 4 * l + j
            if idx < g and kb + idx < kin:
                base = (_row_off(ro + idx) + 16 * w) // 4
                out[:, l, j] = st[base:base + 4]
    return out


@pytest.mark.parametrize("layout", ["native", "row-major"])
@pytest.mark.parametrize("kin,nch,g", [(300, 40, 128), (1001, 33, 64),
                                       (130, 36, 12), (257, 8, 9)])
def test_lane_mapping_matches_the_first_port(rng, layout, kin, nch, g):
    """Every lane holds, in order j = 0..3, in-group elements 4l..4l+3 of
    its channel: the elements the first port's row-major kernel loaded as
    one float4 per lane. So every group and row sum is taken over the same
    operands in the same order."""
    w = rng.normal(size=(kin, nch)).astype(F32)     # the (in, out) leaf
    wt = np.ascontiguousarray(w.T)                  # (out, in) rows
    flat, (sc, sk) = (w.ravel(), (1, nch)) if layout == "native" \
        else (wt.ravel(), (kin, 1))
    gps = SLAB // g
    ng = -(-kin // g)
    for c0 in range(0, nch, TC):
        for sl in range(-(-ng // gps)):
            k0 = sl * gps * g
            st = _stage(flat, sc, sk, c0, k0, min(gps * g, kin - k0), nch)
            for qg in range(gps):
                grp = sl * gps + qg
                if grp >= ng:
                    break
                kb = grp * g
                for wp in range(TC // 4):
                    got = _lane_elements(st, wp, qg * g, g, kb, kin)
                    for i in range(4):
                        c = c0 + 4 * wp + i
                        if c >= nch:
                            continue
                        old = np.zeros(128, F32)           # first port
                        n = min(g, kin - kb)
                        old[:n] = wt[c, kb:kb + n]
                        np.testing.assert_array_equal(got[i],
                                                      old.reshape(32, 4))


def _butterfly(v):
    v = v.astype(F32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(F32)
    return v[0]


def _lane_sum4(d):
    return ((d[:, 0] + d[:, 1]).astype(F32) + d[:, 2]).astype(F32) + d[:, 3]


def _sgn(x):
    return np.sign(x).astype(F32)


def _argmax(bits, at):
    """Phase C's arg-max: redux.max over the lanes' bits, then redux.min
    over the indices of the lanes holding it."""
    m = int(bits.max())
    if m == 0:
        return FULL, 0
    return int(np.where(bits == m, at, FULL).min()), m


def _keys(d):
    """Per element: the bits of |delta| above 3 - j (the kernel's key)."""
    bits = (np.abs(d).view(np.uint32).astype(np.uint64) << 2) & 0xFFFFFFFF
    return (bits | (3 - np.arange(4, dtype=np.uint64))).astype(np.uint32)


def _owner(bb, jb):
    """A group's arg-max: redux.max over the lanes' best bits, then the
    lowest lane of the ballot of lanes holding it, at its own position.
    Returns the in-group index, or None when no lane has a candidate."""
    m = int(bb.max())
    if m == 0:
        return None
    lane = int(np.nonzero(bb == m)[0][0])
    return 4 * lane + int(jb[lane])


def _first_max(ab):
    """Per lane: the largest of its four bit patterns, the lowest j first."""
    jb = np.argmax(ab, axis=1)
    return ab[np.arange(32), jb], jb


def kernel_channel(x, s, g, bits, enable_k, enable_c):
    """Kernel A on one output channel ``x`` (its ``in`` weights), in the
    kernel's own steps, lanes as NumPy rows: returns the int8 codes."""
    kin = x.shape[0]
    qmax = F32(2 ** (bits - 1) - 1)
    ng = -(-kin // g)
    idx = np.arange(128).reshape(32, 4)
    codes = np.zeros(kin, np.int8)
    summ = []
    for grp in range(ng):
        kb = grp * g
        valid = (idx < g) & (kb + idx < kin)
        v = np.where(valid, x[np.minimum(kb + idx, kin - 1)], F32(0))
        t = (v / F32(s)).astype(F32)
        q = np.clip(np.rint(t), -qmax, qmax).astype(F32)
        d = (q - t).astype(F32)
        if enable_k:
            e = _butterfly(_lane_sum4(d))
            tgt = q - _sgn(d)
            el = ((d * e).astype(F32) > 0) & (tgt >= -qmax) & (tgt <= qmax)
            key = np.where(el, _keys(d), 0).astype(np.uint32)
            # each lane's keys sorted once; a round takes the head of the
            # lowest lane holding the largest value
            lists = -np.sort(-key.astype(np.int64), axis=1)
            taken = np.zeros(32, np.int64)
            k = int(np.rint(abs(e)))
            for _ in range(k):                  # none left: the rounds end
                head = np.where(taken < 4,
                                lists[np.arange(32), np.minimum(taken, 3)], 0)
                m = int(head.max())
                if m == 0:
                    break
                taken[int(np.nonzero((head ^ m) < 4)[0][0])] += 1
            head = np.where(taken < 4,
                            lists[np.arange(32), np.minimum(taken, 3)], 0)
            flip = key > head[:, None]          # the rounds mark, then apply
            sg = np.where(flip, _sgn(d), F32(0))
            q = (q - sg).astype(F32)
            d = (d - sg).astype(F32)
        if enable_c:
            e1 = _butterfly(_lane_sum4(d))
            sg1 = _sgn(e1)
            match = (d != 0) if sg1 == 0 else ((d * sg1).astype(F32) > 0)
            tgt = q - _sgn(d)
            ok = match & (tgt >= -qmax) & (tgt <= qmax)
            ab = np.where(ok, np.abs(d).view(np.uint32), 0).astype(np.uint32)
            at = _owner(*_first_max(ab))
            if at is not None:
                summ.append((e1, d[at >> 2, at & 3], at, q[at >> 2, at & 3]))
            else:
                summ.append((e1, F32(0), 0xFF, F32(0)))
        codes[kb + idx[valid]] = q[valid].astype(np.int8)
    if enable_c:
        part = np.zeros(32, F32)
        for gi in range(ng):
            part[gi % 32] = F32(part[gi % 32] + summ[gi][0])
        e_row = _butterfly(part)
        cval = np.array([sm[1] for sm in summ], F32)
        state = ((cval * e_row).astype(F32) > 0).astype(int)
        kc = min(int(np.rint(abs(e_row))), int(state.sum()))
        for _ in range(kc):
            bb = np.zeros(32, np.uint32)
            gb = np.full(32, FULL, np.int64)
            for gi in range(ng):          # lane gi % 32, its groups in order
                b = np.abs(cval[gi]).view(np.uint32)
                if state[gi] == 1 and b > bb[gi % 32]:
                    bb[gi % 32], gb[gi % 32] = b, gi
            gs, _ = _argmax(bb, gb)
            state[gs] = 2
        for gi in np.nonzero(state == 2)[0]:
            _, cv, at, cq = summ[gi]
            codes[gi * g + at] = np.int8(int(cq) - int(_sgn(cv)))
    return codes


STAGE_FLAGS = {"E": (False, False), "EK": (True, False), "EKC": (True, True)}


@pytest.mark.parametrize("stage", sorted(STAGE_FLAGS))
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("kin,g", [(300, 128), (1001, 64), (130, 12),
                                   (257, 9)])
def test_kernel_transcription_equals_plain_on_exact_inputs(rng, stage, bits,
                                                           kin, g):
    ek, ec = STAGE_FLAGS[stage]
    w = grid_weights(rng, kin, 6)                   # 6 channels, (in, out)
    s = F32(0.5 if bits == 8 else 1.0)
    got = np.stack([kernel_channel(w[:, c], s, g, bits, ek, ec)
                    for c in range(6)])
    want = squant_codes(torch.from_numpy(w.T.copy()),
                        torch.full((6, 1), float(s)), bits=bits,
                        group_size=g, enable_k=ek, enable_c=ec)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_transcription_on_random_inputs_within_tie_rule(rng):
    from repro_torch.kernels.ref import explain_code_differences
    w = rng.normal(size=(1000, 16)).astype(F32)
    wt = torch.from_numpy(w.T.copy())
    s = sf.squant_scales_plain([torch.from_numpy(w)], 8)[0]
    got = torch.from_numpy(np.stack([kernel_channel(w[:, c], s[c].item(), 128,
                                                    8, True, True)
                                     for c in range(16)]))
    want = squant_codes(wt, s[:, None], bits=8, group_size=128,
                        enable_k=True, enable_c=True)[0]
    res = explain_code_differences(wt, s[:, None], got, want, bits=8,
                                   group_size=128)
    assert res["unexplained"] == 0, res


# ---------------------------------------------------------------------------
# the scale pass's formula
# ---------------------------------------------------------------------------

def scale_transcribed(w, bits):
    """squant_scale_kernel on an (in, out) leaf: the max of |w|'s bits per
    column, at least eps's bits, times fl32(1/qmax) in float32."""
    bits_abs = (w.view(np.uint32) & 0x7FFFFFFF).max(axis=0)
    m = np.maximum(bits_abs, np.array([1e-12], F32).view(np.uint32))
    inv = F32(1.0 / (2 ** (bits - 1) - 1))
    return (m.view(F32) * inv).astype(F32)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_scale_formula_equals_dispatch_scales(rng, bits):
    w = rng.normal(size=(300, 37)).astype(F32) * 3
    w[:, 3] = 0.0                              # clamped to eps
    w[:, 4] = -0.0
    w[5, 6] = -7.5                             # the max is a negative weight
    w[:, 7] = 1e-20                            # below eps
    got = scale_transcribed(w, bits)
    want = _scales(torch.from_numpy(w.T.copy())[None], bits, "max")[0, :, 0]
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(
        sf.squant_scales_plain([torch.from_numpy(w)], bits)[0].numpy(), got)


@pytest.mark.parametrize("bits", [4, 8])
def test_scale_formula_equals_jax_pipeline_scales(rng, bits):
    leaves = {f"l{i}": {"w": rng.normal(size=(256, 24)).astype(F32) * (i + 1)}
              for i in range(3)}
    tj, _ = jax_quantize_tree({k: {"w": jnp.asarray(v["w"])}
                               for k, v in leaves.items()}, bits=bits,
                              group_size=128, backend="ref")
    for k in sorted(leaves):
        want = np.asarray(tj[k]["w"].scale).reshape(-1)
        np.testing.assert_array_equal(scale_transcribed(leaves[k]["w"], bits),
                                      want)
