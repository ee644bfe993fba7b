"""Kernel B's float32 instances (``tcgemv32``, ``mma32``) on the CPU: the
exact three-way bf16 split of float32 x (``split_bf16x3``), torch-ops
transcriptions of the two instances' orders of summation (three passes,
hi then mid then lo, into one accumulator at every k16 step; splits added
in ascending order) held against the plain version, the JAX
``dequant_matmul_ref`` and the Pallas kernel in interpret mode within 1e-4
(float32's tolerance), and the instances' tile constants read from the
CUDA source."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro_torch.kernels import _build
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.quant.qtypes import pack_int4

torch.set_num_threads(1)

CU = os.path.join(_build.CSRC, "dequant_matmul.cu")
SMEM_PER_SM = 233472       # 228 KB an H100 SM shares among its CTAs
SMEM_PER_CTA = 232448      # the most one CTA may ask for
SMEM_RESERVED = 1024       # the runtime's share of each CTA


def _case(rng, m, n, bits, per_group, b, gs=128):
    """Codes, scales of the size SQuant gives weights of std 1/sqrt(N)
    (outputs of order 1), and float32 x."""
    q = 2 ** (bits - 1) - 1
    codes = rng.integers(-q, q + 1, size=(m, n)).astype(np.int8)
    data = pack_int4(torch.from_numpy(codes)).numpy() if bits <= 4 else codes
    scale = (rng.uniform(0.5, 1.5, size=(m, n // gs if per_group else 1))
             * 3.0 / np.sqrt(n) / q).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    return x, data, scale


def _inputs(kind, rng):
    """float32 values of one kind, every one inside the split's exact
    range."""
    if kind == "random":
        return rng.normal(size=4096).astype(np.float32)
    if kind == "scaled":                 # every binade from 2^-100 to 2^100
        e = rng.integers(-100, 101, size=4096)
        return (rng.uniform(1, 2, size=4096) * 2.0 ** e).astype(np.float32)
    if kind == "large":
        return (rng.uniform(-1, 1, size=4096) * 1e38).astype(np.float32)
    if kind == "tiny":                   # down to 2^-110
        e = rng.integers(-110, -90, size=4096)
        sign = rng.choice([-1.0, 1.0], size=4096)
        return (sign * rng.uniform(1, 2, size=4096) * 2.0 ** e
                ).astype(np.float32)
    if kind == "full_mantissa":   # every mantissa bit set, ties; 2^-110 up
        bits = rng.integers(0, 2 ** 23, size=4096).astype(np.uint32)
        bits[:1024] = 0x7FFFFF
        bits[1024:2048] = (bits[1024:2048] & ~np.uint32(0xFFFF)) | 0x8000
        exp = rng.integers(17, 254, size=4096).astype(np.uint32) << 23
        sign = rng.integers(0, 2, size=4096).astype(np.uint32) << 31
        return (sign | exp | bits).view(np.float32)
    assert kind == "zeros"
    return np.array([0.0, -0.0] * 8, dtype=np.float32)


@pytest.mark.parametrize("kind", ["random", "scaled", "large", "tiny",
                                  "full_mantissa", "zeros"])
def test_split_bf16x3_rebuilds_x_exactly(rng, kind):
    """hi + mid + lo == x in float32, bit for bit (a zero keeps its sign
    in hi); each part is bf16 and at most half an ulp of the part before
    it."""
    xs = torch.from_numpy(_inputs(kind, rng))
    hi, mid, lo = dm.split_bf16x3(xs)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    h, m, lo_ = hi.float(), mid.float(), lo.float()
    back = (h + m) + lo_
    nz = xs != 0
    assert torch.equal(back[nz].view(torch.int32), xs[nz].view(torch.int32))
    assert torch.equal(back, xs)
    assert torch.equal(torch.signbit(h[~nz]), torch.signbit(xs[~nz]))
    # round to nearest: each remainder within half a bf16 ulp (8 bits)
    assert bool((m.abs() <= h.abs() * 2.0 ** -8).all())
    assert bool((lo_.abs() <= m.abs() * 2.0 ** -8).all())
    assert torch.equal(h, xs.to(torch.bfloat16).float())


def test_split_bf16x3_refuses_other_dtypes():
    with pytest.raises(ValueError):
        dm.split_bf16x3(torch.zeros(4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        dm.split_bf16x3(torch.zeros(4, dtype=torch.float64))


def test_three_passes_are_float32_not_one_bf16_pass(rng):
    """The three-pass order stays within float32's rounding of the exact
    (float64) product; one bf16 pass of x would not."""
    x, data, scale = _case(rng, 32, 512, 8, False, 8)
    xt, dt, st = (torch.from_numpy(a) for a in (x, data, scale))
    got = dm.dequant_matmul_tc_order(xt, dt, st, bits=8, group_size=128,
                                     splits=1, gps=4, bf16x3=True)
    exact = x.astype(np.float64) @ (data.astype(np.float64)
                                    * scale.astype(np.float64)).T
    one = (x.astype(np.float32).astype(jnp.bfloat16).astype(np.float64)
           @ (data.astype(np.float64) * scale.astype(np.float64)).T)
    mag = np.abs(exact).max()
    assert np.abs(got.numpy() - exact).max() < 1e-6 * mag
    assert np.abs(one - exact).max() > 1e-4 * mag


@pytest.mark.parametrize("splits,gps", [(1, 4), (2, 2), (4, 1), (2, 3)])
@pytest.mark.parametrize("b", [1, 3, 8, 16])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_tc32_order_matches_plain_and_ref(rng, bits, per_group, b, splits,
                                          gps):
    m, n, gs = 40, 512, 128
    x, data, scale = _case(rng, m, n, bits, per_group, b)
    xt = torch.from_numpy(x)
    got = dm.dequant_matmul_tc_order(xt, torch.from_numpy(data),
                                     torch.from_numpy(scale), bits=bits,
                                     group_size=gs, splits=splits, gps=gps,
                                     bf16x3=True)
    assert got.dtype == torch.float32 and got.shape == (b, m)
    plain = dm.dequant_matmul_plain(xt, torch.from_numpy(data),
                                    torch.from_numpy(scale), bits=bits,
                                    group_size=gs)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    want = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(data),
                                   jnp.asarray(scale), bits=bits,
                                   group_size=gs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("bits,gs", [(8, 64), (8, 256), (4, 128), (4, 256)])
def test_tc32_order_group_sizes(rng, bits, gs):
    """Per-group scales of one k-range (int8, 64 columns) and of several,
    split as the plan splits them on a small card."""
    m, n = 24, 1024
    x, data, scale = _case(rng, m, n, bits, True, 5, gs)
    splits, gps = dm.split_plan(m, n, gs, sms=n // gs, ctas_per_sm=1)
    got = dm.dequant_matmul_tc_order(torch.from_numpy(x),
                                     torch.from_numpy(data),
                                     torch.from_numpy(scale), bits=bits,
                                     group_size=gs, splits=splits, gps=gps,
                                     bf16x3=True)
    want = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(data),
                                   jnp.asarray(scale), bits=bits,
                                   group_size=gs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("splits,gps", [(1, 4), (4, 1)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_group", [False, True])
def test_tc32_order_matches_pallas_interpret(rng, bits, per_group, splits,
                                            gps):
    m, n, gs = 16, 512, 128
    x, data, scale = _case(rng, m, n, bits, per_group, 8)
    got = dm.dequant_matmul_tc_order(torch.from_numpy(x),
                                     torch.from_numpy(data),
                                     torch.from_numpy(scale), bits=bits,
                                     group_size=gs, splits=splits, gps=gps,
                                     bf16x3=True)
    kern = dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(data),
                                 jnp.asarray(scale), bits=bits, group_size=gs,
                                 tb=8, tm=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("splits,ups", [(1, 4), (2, 2), (4, 1), (2, 3)])
@pytest.mark.parametrize("b", [17, 43, 64, 100])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_mma32_order_matches_plain_and_ref(rng, bits, per_group, b, splits,
                                           ups):
    m, n = 136, 4 * dm.PF_UNIT
    x, data, scale = _case(rng, m, n, bits, per_group, b)
    xt = torch.from_numpy(x)
    got = dm.dequant_matmul_mma_order(xt, torch.from_numpy(data),
                                      torch.from_numpy(scale), bits=bits,
                                      splits=splits, ups=ups, bf16x3=True)
    assert got.dtype == torch.float32 and got.shape == (b, m)
    plain = dm.dequant_matmul_plain(xt, torch.from_numpy(data),
                                    torch.from_numpy(scale), bits=bits,
                                    group_size=dm.PF_UNIT)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
    want = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(data),
                                   jnp.asarray(scale), bits=bits,
                                   group_size=dm.PF_UNIT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("b", [17, 64, 100])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_mma32_order_matches_pallas_interpret(rng, bits, per_group, b):
    m, n = 16, 4 * dm.PF_UNIT
    x, data, scale = _case(rng, m, n, bits, per_group, b)
    splits, ups = dm.prefill_plan(b, m, n, dm.PF_UNIT if per_group else None,
                                  sms=4, ctas_per_sm=1, f32=True)
    got = dm.dequant_matmul_mma_order(torch.from_numpy(x),
                                      torch.from_numpy(data),
                                      torch.from_numpy(scale), bits=bits,
                                      splits=splits, ups=ups, bf16x3=True)
    kern = dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(data),
                                 jnp.asarray(scale), bits=bits,
                                 group_size=dm.PF_UNIT, tm=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-4,
                               atol=1e-4)


def test_three_pass_orders_refuse_bf16_x(rng):
    x, data, scale = _case(rng, 16, 512, 8, False, 20)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    args = (xt, torch.from_numpy(data), torch.from_numpy(scale))
    with pytest.raises(ValueError):
        dm.dequant_matmul_mma_order(*args, bits=8, splits=1, ups=4,
                                    bf16x3=True)
    with pytest.raises(ValueError):
        dm.dequant_matmul_tc_order(*args, bits=8, group_size=128, splits=1,
                                   gps=4, bf16x3=True)


@pytest.mark.parametrize("b", [17, 64, 65, 512, 2048])
@pytest.mark.parametrize("per_group", [False, True])
def test_mma32_takes_one_m_tile(b, per_group):
    """``mma32`` takes one 64-token m-tile a CTA at every row count, and
    its plan counts its tiles so."""
    assert dm.prefill_tile_rows(b, per_group, f32=True) == dm.PF_M_TILE
    gs = dm.PF_UNIT if per_group else None
    splits, ups = dm.prefill_plan(b, 1024, 1024, gs, 132, 2, f32=True)
    tiles = 8 * -(-b // dm.PF_M_TILE)
    assert tiles * splits <= max(264, tiles)
    assert splits * ups >= 8 > (splits - 1) * ups


@pytest.mark.parametrize("m,n", [(1024, 1024), (4096, 1024), (1024, 4096),
                                 (256206, 1024), (37, 128)])
@pytest.mark.parametrize("b", [17, 64, 512, 2048])
@pytest.mark.parametrize("per_group", [False, True])
def test_mma32_plan_covers_every_unit_once(m, n, b, per_group):
    """``mma32``'s plan: every unit once, in order; one wave at most; at
    most N / B splits (float32 partials as wide as the float32 x read
    anyway), two units a split at least."""
    gs = dm.PF_UNIT if per_group else None
    splits, ups = dm.prefill_plan(b, m, n, gs, 132, 2, f32=True)
    units = n // dm.PF_UNIT
    ranges = [range(s * ups, min(units, s * ups + ups)) for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [u for r in ranges for u in r] == list(range(units))
    tiles = -(-m // dm.PF_ROWS) * -(-b // dm.PF_M_TILE)
    assert tiles * splits <= max(264, tiles)
    assert splits == 1 or (splits <= n // b and ups >= 2)


def test_mma32_plan_at_seamless_shapes():
    """The plans seamless's float32 prefill and cross K/V take on a
    132-SM card: the cross K/V at 512 rows splits in two (the bf16 rule's
    N / (2B) would not split it), the 2 048-row prefill does not split."""
    plan = lambda b, m, n: dm.prefill_plan(b, m, n, None, 132, 2, f32=True)
    assert plan(512, 1024, 1024) == (2, 4)
    assert dm.prefill_plan(512, 1024, 1024, None, 132, 2) == (1, 8)
    assert plan(512, 1024, 4096) == (4, 8)
    assert plan(2048, 1024, 1024) == plan(2048, 4096, 1024) == (1, 8)
    assert plan(2048, 256206, 1024) == (1, 8)


def _const(src, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def test_float32_constants_shared_with_the_kernel_source():
    """The float32 instances' tiles as ``csrc/dequant_matmul.cu`` is
    compiled with them: variant ids, the ``mma32`` x boxes (128 bytes of
    float32, two a stage), one m-tile, and rings that fit the card's
    shared memory (two CTAs an SM where the instance is on the main
    path's shapes: int8 at up to 8 rows, and every ``mma32``)."""
    src = open(CU).read()
    ids = re.search(r"enum Variant \{ GEMV = 0, TCGEMV = 1, MMA = 2, "
                    r"TILED = 3, TCGEMV32 = 4, MMA32 = 5 \};", src)
    assert ids is not None
    assert dm.VARIANTS.index("tcgemv32") == 4 and dm.VARIANTS.index(
        "mma32") == 5
    assert "static_assert(!F32 || MT == 1" in src
    # mma32: x stages of two swizzle boxes, one m-tile, PF_X32_NSTAGE deep
    cols, bk = _const(src, "PF_X32_COLS"), _const(src, "PF_BK")
    assert cols * 4 == 128 and bk == 2 * cols
    ns, bm, bn = (_const(src, k) for k in ("PF_X32_NSTAGE", "PF_BM", "PF_BN"))
    assert bm == dm.PF_M_TILE and bn == dm.PF_ROWS
    for packed in (False, True):
        c_bytes = bn * bk // (2 if packed else 1)
        smem = 1024 + ns * (bm * bk * 4 + c_bytes) + 2 * bn * bk * 2 + 16 * ns
        assert 2 * (smem + SMEM_RESERVED) <= SMEM_PER_SM
    # tcgemv32: TC_NSTAGE stages of the int8 one-n-tile ring, fewer (at
    # least 3) where x takes more vectors
    warps, nstage, mt = (_const(src, k) for k in ("TC_WARPS", "TC_NSTAGE",
                                                  "TC_MT"))
    assert "constexpr int TC_F32_RING = TC_NSTAGE * tc_stage_bytes<1, " \
           "false, true>();" in src

    def stage(nt, packed):
        xv = (4 if packed else 2) * 2
        return warps * 32 * (16 * (2 * mt + xv * nt) + 4 * 2 * mt)

    ring = nstage * stage(1, False)
    assert 2 * (ring + SMEM_RESERVED) <= SMEM_PER_SM
    for nt in (1, 2):
        for packed in (False, True):
            stages = max(3, ring // stage(nt, packed))
            assert stages <= nstage
            assert stages * stage(nt, packed) <= SMEM_PER_CTA
