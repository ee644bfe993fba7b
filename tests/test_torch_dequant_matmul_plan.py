"""Kernel B's decode variant (``tcgemv``) on the CPU: the rule that picks a
variant, the split plan, the k16 column order, and a torch-ops transcription
of the variant's order of summation (per-group partial dot, then its scale,
splits added in ascending order) held against the plain version, the JAX
``dequant_matmul_ref`` and the Pallas kernel in interpret mode — float32
within 1e-4, bfloat16 within 2e-2 (the reference's own tolerances)."""
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


def _case(rng, m, n, bits, per_group, gs, b):
    q = 2 ** (bits - 1) - 1
    codes = rng.integers(-q, q + 1, size=(m, n)).astype(np.int8)
    data = pack_int4(torch.from_numpy(codes)).numpy() if bits <= 4 else codes
    scale = rng.uniform(0.01, 0.1, size=(m, n // gs if per_group else 1)
                        ).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    return x, data, scale


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize("splits,gps", [(1, 4), (2, 2), (4, 1), (2, 3)])
@pytest.mark.parametrize("b", [1, 3, 8, 16])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tc_order_matches_plain_and_ref(rng, dtype, bits, per_group, b,
                                        splits, gps):
    m, n, gs = 40, 512, 128
    x, data, scale = _case(rng, m, n, bits, per_group, gs, b)
    xt = torch.from_numpy(x).to(dtype)
    got = dm.dequant_matmul_tc_order(xt, torch.from_numpy(data),
                                     torch.from_numpy(scale), bits=bits,
                                     group_size=gs, splits=splits, gps=gps)
    assert got.dtype == dtype and got.shape == (b, m)
    plain = dm.dequant_matmul_plain(xt, torch.from_numpy(data),
                                    torch.from_numpy(scale), bits=bits,
                                    group_size=gs)
    tol = _tol(dtype)
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = jref.dequant_matmul_ref(jx, jnp.asarray(data), jnp.asarray(scale),
                                   bits=bits, group_size=gs)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("bits,gs", [(8, 64), (8, 256), (4, 128), (4, 256)])
@pytest.mark.parametrize("per_group", [False, True])
def test_tc_order_group_sizes(rng, bits, gs, per_group):
    """A group of one k-range (int8, 64 columns) and of several."""
    m, n = 24, 1024
    x, data, scale = _case(rng, m, n, bits, per_group, gs, 5)
    ng = n // gs
    splits, gps = dm.split_plan(m, n, gs, sms=ng, ctas_per_sm=1)
    assert splits > 1
    got = dm.dequant_matmul_tc_order(torch.from_numpy(x),
                                     torch.from_numpy(data),
                                     torch.from_numpy(scale), bits=bits,
                                     group_size=gs, splits=splits, gps=gps)
    want = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(data),
                                   jnp.asarray(scale), bits=bits,
                                   group_size=gs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("splits,gps", [(1, 4), (4, 1)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("per_group", [False, True])
def test_tc_order_matches_pallas_interpret(rng, bits, per_group, splits,
                                          gps):
    m, n, gs = 16, 512, 128
    x, data, scale = _case(rng, m, n, bits, per_group, gs, 8)
    got = dm.dequant_matmul_tc_order(torch.from_numpy(x),
                                     torch.from_numpy(data),
                                     torch.from_numpy(scale), bits=bits,
                                     group_size=gs, splits=splits, gps=gps)
    kern = dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(data),
                                 jnp.asarray(scale), bits=bits, group_size=gs,
                                 tb=8, tm=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-4,
                               atol=1e-4)


def test_tc_order_refuses_a_plan_that_does_not_cover(rng):
    x, data, scale = _case(rng, 8, 512, 8, False, 128, 2)
    args = (torch.from_numpy(x), torch.from_numpy(data),
            torch.from_numpy(scale))
    for splits, gps in [(1, 3), (3, 2), (5, 1)]:
        with pytest.raises(ValueError):
            dm.dequant_matmul_tc_order(*args, bits=8, group_size=128,
                                       splits=splits, gps=gps)
    with pytest.raises(ValueError):               # 32 is not a k-range
        dm.dequant_matmul_tc_order(*args, bits=8, group_size=32, splits=1,
                                   gps=16)


@pytest.mark.parametrize("bits", [4, 8])
def test_tc_column_order_is_a_permutation_of_each_lanes_columns(bits):
    """Every column of a k-range exactly once, and the k-slots of lane tig
    (2*tig, 2*tig+1, 2*tig+8, 2*tig+9 of every k16 step) all inside the
    16 code bytes that lane holds."""
    kr = dm.tc_krange(bits)
    order = dm.tc_column_order(bits).tolist()
    assert sorted(order) == list(range(kr))
    per_lane = kr // 4
    for j in range(kr // 16):
        for s in range(16):
            tig = (s & 7) >> 1
            assert order[16 * j + s] // per_lane == tig


M_N = [(1024, 4096), (4096, 4096), (12800, 4096), (4096, 12800), (37, 192),
       (300, 1000), (1, 128), (129, 65536)]


@pytest.mark.parametrize("m,n", M_N)
@pytest.mark.parametrize("gs", [64, 128, 256])
@pytest.mark.parametrize("sms,ctas", [(132, 1), (132, 2), (114, 3), (1, 1)])
def test_split_plan_covers_every_group_once(m, n, gs, sms, ctas):
    if n % gs:
        with pytest.raises(ValueError):
            dm.split_plan(m, n, gs, sms, ctas)
        return
    splits, gps = dm.split_plan(m, n, gs, sms, ctas)
    assert (splits, gps) == dm.split_plan(m, n, gs, sms, ctas)
    ng = n // gs
    assert 1 <= splits <= ng and gps >= 1
    ranges = [range(s * gps, min(ng, s * gps + gps)) for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    groups = [g for r in ranges for g in r]
    assert groups == list(range(ng))              # each once, in order
    # every split starts on a group boundary: its first column is g * gs
    starts = [r.start * gs for r in ranges]
    assert all(c % gs == 0 for c in starts) and starts[0] == 0
    # one wave of CTAs at most, and at least half of the splits that fit it
    row_ctas = -(-m // dm.TC_ROWS)
    want = min(max(1, sms * ctas // row_ctas), ng)
    assert splits <= want and 2 * splits >= want
    assert row_ctas * splits <= max(sms * ctas, row_ctas)


def test_split_plan_main_path():
    """The plans of granite-3-8b's decode linears on a 132-SM card."""
    got = {mn: dm.split_plan(*mn, 128, 132, dm.TC_CTAS_PER_SM)
           for mn in M_N[:4]}
    assert all(s * p >= n // 128 for (m, n), (s, p) in got.items())
    assert got[(1024, 4096)][0] > got[(4096, 4096)][0] >= 2
    with pytest.raises(ValueError):
        dm.split_plan(0, 4096, 128)
    with pytest.raises(ValueError):
        dm.split_plan(64, 4096, 128, sms=0)


ALIGNED = 1 << 20


@pytest.mark.parametrize("b,n,gs,scols,bits,bf16,xp,cp,want", [
    (8, 4096, 128, 1, 8, True, ALIGNED, ALIGNED, "tcgemv"),
    (1, 4096, 128, 32, 4, True, ALIGNED, ALIGNED, "tcgemv"),
    (16, 12800, 128, 1, 8, True, ALIGNED, ALIGNED, "tcgemv"),
    (8, 1024, 64, 16, 8, True, ALIGNED, ALIGNED, "tcgemv"),
    (8, 1024, 64, 16, 4, True, ALIGNED, ALIGNED, "gemv"),     # < 128
    (8, 1024, 32, 32, 8, True, ALIGNED, ALIGNED, "gemv"),
    (8, 1000, 1000, 1, 8, True, ALIGNED, ALIGNED, "gemv"),    # ragged N
    (8, 4096, 128, 1, 8, True, ALIGNED, ALIGNED + 1, "gemv"),  # codes
    (8, 4096, 128, 1, 8, True, ALIGNED + 8, ALIGNED, "gemv"),  # x
    (8, 4096, 128, 1, 8, False, ALIGNED, ALIGNED, "tcgemv32"),  # float32
    (16, 4096, 128, 1, 4, False, ALIGNED, ALIGNED, "tcgemv32"),
    (8, 1024, 64, 16, 8, False, ALIGNED, ALIGNED, "tcgemv32"),
    (8, 1024, 64, 16, 4, False, ALIGNED, ALIGNED, "gemv"),    # < 128
    (8, 1000, 1000, 1, 8, False, ALIGNED, ALIGNED, "gemv"),   # ragged N
    (8, 4096, 128, 1, 8, False, ALIGNED, ALIGNED + 1, "gemv"),  # codes
    (8, 4096, 128, 1, 8, False, ALIGNED + 4, ALIGNED, "gemv"),  # x
    (1, 4096, 128, 1, 8, False, ALIGNED + 8, ALIGNED, "gemv"),
    (17, 4096, 128, 1, 8, True, ALIGNED, ALIGNED, "mma"),
    (64, 4096, 128, 32, 4, True, ALIGNED, ALIGNED, "mma"),
    (64, 4096, 64, 64, 8, True, ALIGNED, ALIGNED, "tiled"),
    (64, 4096, 128, 1, 8, False, ALIGNED, ALIGNED, "mma32"),
    (64, 1000, 1000, 1, 8, True, ALIGNED, ALIGNED, "tiled"),
    (64, 1000, 1000, 1, 8, False, ALIGNED, ALIGNED, "tiled"),  # ragged N
    (64, 4096, 128, 1, 8, False, ALIGNED + 4, ALIGNED, "tiled"),  # x
])
def test_variant_rule(b, n, gs, scols, bits, bf16, xp, cp, want):
    assert dm.variant(b, n, gs, scols, bits, bf16, xp, cp) == want


def test_constants_shared_with_the_kernel_source():
    """The wrapper's small-batch limit, row tile and variant ids (the
    float32 instances' too) are the ones ``csrc/dequant_matmul.cu`` is
    compiled with."""
    src = open(CU).read()
    assert int(re.search(r"constexpr int SMALL_BATCH_MAX = (\d+);",
                         src).group(1)) == dm.GEMV_MAX_BATCH
    warps = int(re.search(r"constexpr int TC_WARPS = (\d+);", src).group(1))
    mt = int(re.search(r"constexpr int TC_MT = (\d+);", src).group(1))
    assert warps * mt * 16 == dm.TC_ROWS
    ids = re.search(r"enum Variant \{ GEMV = 0, TCGEMV = 1, MMA = 2, "
                    r"TILED = 3, TCGEMV32 = 4, MMA32 = 5 \};", src)
    assert ids is not None
    assert dm.VARIANTS == ("gemv", "tcgemv", "mma", "tiled", "tcgemv32",
                           "mma32")
