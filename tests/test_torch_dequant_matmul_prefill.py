"""Kernel B's prefill variant (``mma``) on the CPU: its split plan, the tile
constants shared with the CUDA source, the rows of the variant rule that
reach it, and a torch-ops transcription of its order of summation
(per-channel: a CTA's dot product over its columns of a tile times the
scale once; per-group: each group's partial times its scale in ascending
order; a tile's CTA segments added in ascending order) held against the plain version, the JAX
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
GS = dm.PF_UNIT


def _case(rng, m, n, bits, per_group, b):
    """Codes, x, and scales of the size SQuant gives weights of std
    1/sqrt(N), so that outputs are of order 1 like a model's."""
    q = 2 ** (bits - 1) - 1
    codes = rng.integers(-q, q + 1, size=(m, n)).astype(np.int8)
    data = pack_int4(torch.from_numpy(codes)).numpy() if bits <= 4 else codes
    scale = (rng.uniform(0.5, 1.5, size=(m, n // GS if per_group else 1))
             * 3.0 / np.sqrt(n) / q).astype(np.float32)
    x = rng.normal(size=(b, n)).astype(np.float32)
    return x, data, scale


def _order(x, data, scale, bits, splits, ups):
    return dm.dequant_matmul_mma_order(x, torch.from_numpy(data),
                                       torch.from_numpy(scale), bits=bits,
                                       splits=splits, ups=ups)


@pytest.mark.parametrize("splits,ups", [(1, 4), (2, 2), (4, 1), (2, 3)])
@pytest.mark.parametrize("b", [17, 43, 64, 100])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mma_order_matches_plain_and_ref(rng, dtype, bits, per_group, b,
                                         splits, ups):
    m, n = 136, 4 * GS
    x, data, scale = _case(rng, m, n, bits, per_group, b)
    xt = torch.from_numpy(x).to(dtype)
    got = _order(xt, data, scale, bits, splits, ups)
    assert got.dtype == dtype and got.shape == (b, m)
    plain = dm.dequant_matmul_plain(xt, torch.from_numpy(data),
                                    torch.from_numpy(scale), bits=bits,
                                    group_size=GS)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), plain.float(), rtol=tol, atol=tol)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16
                               else jnp.float32)
    want = jref.dequant_matmul_ref(jx, jnp.asarray(data), jnp.asarray(scale),
                                   bits=bits, group_size=GS)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b", [17, 43, 64, 100])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_mma_order_matches_pallas_interpret(rng, bits, per_group, b):
    m, n = 16, 4 * GS
    x, data, scale = _case(rng, m, n, bits, per_group, b)
    splits, ups = (2, 2) if b > 64 else (4, 1)
    got = _order(torch.from_numpy(x), data, scale, bits, splits, ups)
    kern = dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(data),
                                 jnp.asarray(scale), bits=bits, group_size=GS,
                                 tm=8, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-4,
                               atol=1e-4)


def test_mma_order_refuses_what_the_kernel_refuses(rng):
    x, data, scale = _case(rng, 8, 4 * GS, 8, False, 20)
    xt = torch.from_numpy(x)
    for splits, ups in [(1, 3), (3, 2), (5, 1)]:      # miss or empty splits
        with pytest.raises(ValueError):
            _order(xt, data, scale, 8, splits, ups)
    with pytest.raises(ValueError):                   # groups of 64
        _order(xt, data, np.ones((8, 8), np.float32), 8, 1, 4)


M_N = [(1024, 4096), (4096, 4096), (12800, 4096), (4096, 12800), (1000, 4096),
       (37, 128), (129, 65536)]


@pytest.mark.parametrize("m,n", M_N)
@pytest.mark.parametrize("b", [17, 43, 64, 100, 256, 384, 4096])
@pytest.mark.parametrize("per_group", [False, True])
@pytest.mark.parametrize("sms,ctas", [(132, 1), (132, 2), (114, 3), (1, 1)])
def test_prefill_plan_covers_every_unit_once(m, n, b, per_group, sms, ctas):
    gs = GS if per_group else None
    splits, ups = dm.prefill_plan(b, m, n, gs, sms, ctas)
    assert (splits, ups) == dm.prefill_plan(b, m, n, gs, sms, ctas)
    units = n // GS
    assert 1 <= splits <= units and ups >= 1
    ranges = [range(s * ups, min(units, s * ups + ups)) for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [u for r in ranges for u in r] == list(range(units))
    # one wave of CTAs at most (unless the output tiles alone exceed it),
    # partials no larger than the codes, two units a split at least, and
    # at least half of the splits those limits allow
    tiles = -(-m // dm.PF_ROWS) * -(-b // dm.prefill_tile_rows(b, per_group))
    assert tiles * splits <= max(sms * ctas, tiles)
    assert splits == 1 or (4 * b * m * splits <= 2 * m * n and ups >= 2)
    most = max(1, min(sms * ctas // tiles, n // (2 * b), units // 2))
    assert splits <= most and 2 * splits >= min(most, units)


def test_prefill_plan_main_path():
    """The plans of granite-3-8b's prefill linears on a 132-SM card at
    phase 6's 64-row chunk and the round path's 256 and 384 rows (the
    splits that timed best in scripts/dequant_matmul_sweep.py)."""
    plans = {(b, m, n): dm.prefill_plan(b, m, n, None, 132,
                                        dm.PF_CTAS_PER_SM)
             for b in (64, 256, 384) for m, n in M_N[:4]}
    assert [plans[(64, m, n)][0] for m, n in M_N[:4]] == [16, 8, 2, 8]
    assert [plans[(256, m, n)][0] for m, n in M_N[:4]] == [8, 4, 1, 4]
    assert [plans[(384, m, n)][0] for m, n in M_N[:4]] == [5, 2, 1, 2]


@pytest.mark.parametrize("args", [(0, 64, 4096, None), (64, 0, 4096, None),
                                  (64, 64, 4000, None), (64, 64, 4096, 64),
                                  (64, 64, 4096, 256)])
def test_prefill_plan_refuses(args):
    with pytest.raises(ValueError):
        dm.prefill_plan(*args)


def test_prefill_tile_rows():
    assert dm.prefill_tile_rows(17, False) == 64
    assert dm.prefill_tile_rows(dm.PF_MT1_MAX_B, False) == 64
    assert dm.prefill_tile_rows(dm.PF_MT1_MAX_B + 1, False) == 128
    assert dm.prefill_tile_rows(384, True) == 64


ALIGNED = 1 << 20


@pytest.mark.parametrize("b,n,gs,scols,bits,bf16,xp,cp,want", [
    (17, 4096, 128, 1, 8, True, ALIGNED, ALIGNED, "mma"),
    (43, 12800, 128, 100, 8, True, ALIGNED, ALIGNED, "mma"),
    (64, 4096, 128, 1, 4, True, ALIGNED, ALIGNED, "mma"),
    (384, 4096, 4096, 1, 8, True, ALIGNED, ALIGNED, "mma"),   # per-channel
    (4096, 128, 128, 1, 4, True, ALIGNED, ALIGNED, "mma"),
    (17, 4096, 128, 1, 8, True, ALIGNED + 2, ALIGNED, "tiled"),  # x
    (64, 4096, 128, 1, 8, True, ALIGNED, ALIGNED + 8, "tiled"),  # codes
    (64, 4096, 256, 16, 8, True, ALIGNED, ALIGNED, "tiled"),     # groups
    (64, 4032, 4032, 1, 8, True, ALIGNED, ALIGNED, "tiled"),     # ragged N
    (64, 4096, 128, 1, 8, False, ALIGNED, ALIGNED, "mma32"),     # float32
    (16, 4096, 128, 1, 8, True, ALIGNED, ALIGNED, "tcgemv"),
    (17, 1024, 128, 1, 8, False, ALIGNED, ALIGNED, "mma32"),
    (512, 1024, 128, 8, 4, False, ALIGNED, ALIGNED, "mma32"),
    (2048, 1024, 1024, 1, 8, False, ALIGNED, ALIGNED, "mma32"),  # per-channel
    (64, 4096, 128, 1, 8, False, ALIGNED + 4, ALIGNED, "tiled"),  # x
    (64, 4096, 128, 1, 8, False, ALIGNED, ALIGNED + 8, "tiled"),  # codes
    (64, 4096, 256, 16, 8, False, ALIGNED, ALIGNED, "tiled"),     # groups
    (64, 4032, 4032, 1, 8, False, ALIGNED, ALIGNED, "tiled"),     # ragged N
    (16, 4096, 128, 1, 8, False, ALIGNED, ALIGNED, "tcgemv32"),
])
def test_variant_rule_prefill_rows(b, n, gs, scols, bits, bf16, xp, cp, want):
    assert dm.variant(b, n, gs, scols, bits, bf16, xp, cp) == want


def test_prefill_constants_shared_with_the_kernel_source():
    """The wrapper's prefill tile, unit and m-tile rule are the ones
    ``csrc/dequant_matmul.cu`` is compiled with."""
    src = open(CU).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("PF_BN") == dm.PF_ROWS
    assert const("PF_BM") == dm.PF_M_TILE
    assert const("PF_UNIT") == dm.PF_UNIT
    assert const("PF_MT1_MAX_B") == dm.PF_MT1_MAX_B
    assert const("PF_UNIT") % const("PF_BK") == 0
    assert "scols == 1 && b > PF_MT1_MAX_B ? 2 : 1" in src
    assert "mma_kernel" not in src
