"""The CUDA kernels against their plain versions, on a GPU. Skipped where
there is no CUDA device; ``chip_smoke.py`` makes the same comparisons at full
width. Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py``.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("m,n,g", [(64, 512, 128), (37, 1000, 128),
                                   (33, 1001, 128), (16, 300, 12)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ek,ec", [(False, False), (True, False),
                                   (True, True)])
def test_squant_flip_kernel_equals_plain(dev, m, n, g, bits, ek, ec):
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randint(-400, 401, (m, n), generator=gen, device=dev).float() / 64
    s = torch.full((m, 1), 1.0, device=dev)
    kw = dict(bits=bits, group_size=g, enable_k=ek, enable_c=ec)
    before = sf.launches
    got = sf.squant_flip(w, s, **kw)
    assert sf.launches == before + 1
    assert torch.equal(got, sf.squant_flip_plain(w, s, **kw))


@pytest.mark.parametrize("b", [1, 5, 16, 70])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,n,per_group", [(256, 512, True), (100, 1000, False),
                                           (64, 130, False)])
def test_dequant_matmul_kernel_close_to_plain(dev, b, bits, dtype, m, n,
                                              per_group):
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.quant.qtypes import pack_int4
    gen = torch.Generator(device=dev).manual_seed(0)
    q = 2 ** (bits - 1) - 1
    codes = torch.randint(-q, q + 1, (m, n), generator=gen, device=dev,
                          dtype=torch.int8)
    data = pack_int4(codes) if bits <= 4 else codes
    gs = 128 if n % 128 == 0 else n
    sc = torch.rand((m, n // gs if per_group else 1), generator=gen,
                    device=dev) * 0.01 + 0.001
    x = torch.randn((b, n), generator=gen, device=dev).to(dtype)
    before = dm.launches
    y = dm.dequant_matmul(x, data, sc, bits=bits, group_size=gs)
    assert dm.launches == before + 1 and y.dtype == dtype
    r = dm.dequant_matmul_plain(x, data, sc, bits=bits, group_size=gs)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), r.float(), rtol=tol, atol=tol)


def _dm_case(dev, m, n, bits, scols, seed=0, b=8, dtype=torch.bfloat16):
    """Random codes, scales of the size SQuant gives weights of std
    1/sqrt(N) (outputs of order 1), and x."""
    from repro_torch.quant.qtypes import pack_int4
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = 2 ** (bits - 1) - 1
    codes = torch.randint(-q, q + 1, (m, n), generator=gen, device=dev,
                          dtype=torch.int8)
    data = pack_int4(codes) if bits <= 4 else codes
    sc = (torch.rand((m, scols), generator=gen, device=dev) + 0.5) * \
        (3.0 / n ** 0.5 / q)
    x = torch.randn((b, n), generator=gen, device=dev).to(dtype)
    return x, data, sc


def _dm_check(x, data, sc, bits, gs, want_variant):
    """One launch: the variant the rule names ran, once, within the
    tolerance of the plain version (float32 1e-4, bfloat16 2e-2)."""
    from repro_torch.kernels import dequant_matmul as dm
    assert dm.variant(x.shape[0], x.shape[1], gs, sc.shape[1], bits,
                      x.dtype == torch.bfloat16, x.data_ptr(),
                      data.data_ptr()) == want_variant
    before, by = dm.launches, dm.launches_by_variant[want_variant]
    y = dm.dequant_matmul(x, data, sc, bits=bits, group_size=gs)
    assert dm.launches == before + 1
    assert dm.launches_by_variant[want_variant] == by + 1
    assert y.dtype == x.dtype and y.shape == (x.shape[0], data.shape[0])
    r = dm.dequant_matmul_plain(x, data, sc, bits=bits, group_size=gs)
    tol = 1e-4 if x.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(y.float(), r.float(), rtol=tol, atol=tol)
    return y


@pytest.mark.parametrize("m,n", [(1024, 4096), (4096, 4096), (12800, 4096),
                                 (4096, 12800)])
@pytest.mark.parametrize("b", [1, 4, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_tcgemv_main_path_shapes(dev, m, n, b, bits):
    """The decode linears of granite-3-8b: bf16 x, per-channel scales."""
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=b)
    _dm_check(x, data, sc, bits, 128, "tcgemv")


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("b", [1, 8, 16])
def test_tcgemv_group_sizes(dev, gs, bits, b):
    """Per-group scales; a group that is not a whole number of k-ranges
    (64 columns int8, 128 packed) goes to gemv."""
    from repro_torch.kernels import dequant_matmul as dm
    m, n = 384, 1024
    x, data, sc = _dm_case(dev, m, n, bits, n // gs, b=b)
    want = "tcgemv" if gs % dm.tc_krange(bits) == 0 else "gemv"
    _dm_check(x, data, sc, bits, gs, want)


@pytest.mark.parametrize("m,n,want", [(200, 1024, "tcgemv"),
                                      (1000, 4096, "tcgemv"),
                                      (37, 192, "tcgemv"),
                                      (100, 1000, "gemv"),
                                      (64, 96, "gemv")])
@pytest.mark.parametrize("bits", [8, 4])
def test_tcgemv_ragged_rows_and_columns(dev, m, n, want, bits):
    """M not a multiple of the 128-row tile is masked in tcgemv; N not a
    whole number of k-ranges (the group is then the whole row) goes to
    gemv."""
    from repro_torch.kernels import dequant_matmul as dm
    gs = 128 if n % 128 == 0 else n
    if want == "tcgemv" and gs % dm.tc_krange(bits):
        want = "gemv"
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=5)
    _dm_check(x, data, sc, bits, gs, want)


@pytest.mark.parametrize("offset,want", [(1, "gemv"), (16, "tcgemv")])
def test_tcgemv_code_alignment(dev, offset, want):
    """A contiguous code view that does not start on 16 bytes goes to
    gemv; one that does stays on tcgemv."""
    m, n = 256, 1024
    x, data, sc = _dm_case(dev, m, n, 8, 1)
    buf = torch.empty(m * n + 64, dtype=torch.int8, device=dev)
    view = buf[offset:offset + m * n].view(m, n)
    view.copy_(data)
    _dm_check(x, view, sc, 8, 128, want)


@pytest.mark.parametrize("m,n", [(1024, 4096), (4096, 12800)])
@pytest.mark.parametrize("bits", [8, 4])
def test_tcgemv_deterministic(dev, m, n, bits):
    """Split K (these shapes split) merges in a fixed order: two launches
    give the same bits."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, m, n, bits, n // 128)
    _, splits, _ = dm.launch_plan(x, data, m, sc.shape[1], 128, bits)
    assert splits > 1
    y1 = dm.dequant_matmul(x, data, sc, bits=bits, group_size=128)
    y2 = dm.dequant_matmul(x, data, sc, bits=bits, group_size=128)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("plan", [("tcgemv", 1, 32), ("tcgemv", 4, 8),
                                  ("tcgemv", 32, 1), ("tcgemv", 3, 11),
                                  ("gemv", 1, 32)])
def test_explicit_plan_close_to_plain(dev, plan):
    """A plan given to the wrapper (other splits, another variant) runs as
    given, within the bf16 tolerance of the plain version."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 1024, 4096, 8, 1)
    before = dm.launches_by_variant[plan[0]]
    y = dm.dequant_matmul(x, data, sc, bits=8, group_size=128, plan=plan)
    assert dm.launches_by_variant[plan[0]] == before + 1
    r = dm.dequant_matmul_plain(x, data, sc, bits=8, group_size=128)
    torch.testing.assert_close(y.float(), r.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("plan", [("tcgemv", 2, 8), ("tcgemv", 2, 32),
                                  ("tcgemv", 0, 32)])
def test_explicit_plan_refused(dev, plan):
    """Splits that miss groups, hold none or no split at all are refused
    by the kernel."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 1024, 4096, 8, 1)
    with pytest.raises(RuntimeError):
        dm.dequant_matmul(x, data, sc, bits=8, group_size=128, plan=plan)


@pytest.mark.parametrize("m,n", [(4096, 4096), (4096, 12800)])
@pytest.mark.parametrize("b", [1, 8, 16])
def test_float32_small_batch_stays_on_cuda_cores(dev, m, n, b):
    """float32 x at up to 16 rows takes tcgemv32 (three exact bf16 passes
    on the tensor cores, never one rounded pass): within float32's 1e-4."""
    x, data, sc = _dm_case(dev, m, n, 8, 1, b=b, dtype=torch.float32)
    _dm_check(x, data, sc, 8, 128, "tcgemv32")


# seamless-m4t-medium's projections (q/k/v/o and cross K/V, FFN in, FFN
# down), the rows its round path gives them (decode 8, the cross K/V's
# 8 x 64 frames, a prefill's 8 x 256) and the chunk tails 17 / 43 / 64
F32_MN = [(1024, 1024), (4096, 1024), (1024, 4096)]


@pytest.mark.parametrize("m,n", F32_MN)
@pytest.mark.parametrize("b", [1, 8, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_tcgemv32_seamless_shapes(dev, m, n, b, bits):
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=b, dtype=torch.float32)
    _dm_check(x, data, sc, bits, 128, "tcgemv32")


@pytest.mark.parametrize("m,n", F32_MN)
@pytest.mark.parametrize("b", [17, 43, 64, 512, 2048])
@pytest.mark.parametrize("bits", [8, 4])
def test_mma32_seamless_shapes(dev, m, n, b, bits):
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=b, dtype=torch.float32)
    _dm_check(x, data, sc, bits, 128, "mma32")


@pytest.mark.parametrize("b", [8, 17, 300])
@pytest.mark.parametrize("bits", [8, 4])
def test_float32_group_scales(dev, b, bits):
    """Per-group scales (groups of 128) on both float32 instances."""
    x, data, sc = _dm_case(dev, 384, 2048, bits, 2048 // 128, b=b,
                           dtype=torch.float32)
    _dm_check(x, data, sc, bits, 128, "tcgemv32" if b <= 16 else "mma32")


@pytest.mark.parametrize("m", [100, 1000])
@pytest.mark.parametrize("b", [5, 43, 200])
@pytest.mark.parametrize("bits", [8, 4])
def test_float32_ragged_rows(dev, m, b, bits):
    """M not a multiple of the row tile, B not a multiple of the m-tile
    or n-tile: masked, zero-filled."""
    x, data, sc = _dm_case(dev, m, 1024, bits, 1, b=b, dtype=torch.float32)
    _dm_check(x, data, sc, bits, 128, "tcgemv32" if b <= 16 else "mma32")


def test_float32_head_shape(dev):
    """seamless's untied head (256 206 rows, a ragged last row tile) at a
    decode batch and at a prefill's rows."""
    for b, want in ((8, "tcgemv32"), (256, "mma32")):
        x, data, sc = _dm_case(dev, 256206, 1024, 8, 1, b=b,
                               dtype=torch.float32)
        _dm_check(x, data, sc, 8, 128, want)
        del x, data, sc
        torch.cuda.empty_cache()


@pytest.mark.parametrize("m,n,b", [(1024, 1024, 8), (1024, 4096, 16),
                                   (1024, 1024, 512), (4096, 1024, 64)])
@pytest.mark.parametrize("bits", [8, 4])
def test_float32_deterministic(dev, m, n, b, bits):
    """Two launches give the same bits (split K merged in a fixed
    order)."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=b, dtype=torch.float32)
    y1 = dm.dequant_matmul(x, data, sc, bits=bits, group_size=128)
    y2 = dm.dequant_matmul(x, data, sc, bits=bits, group_size=128)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("plan", [("tcgemv32", 1, 32), ("tcgemv32", 4, 8),
                                  ("tcgemv32", 3, 11), ("gemv", 1, 32)])
def test_float32_explicit_small_plan_close_to_plain(dev, plan):
    """Plans given to the wrapper at 8 float32 rows, the old gemv among
    them (the timing's comparison), within float32's 1e-4."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 1024, 4096, 8, 1, dtype=torch.float32)
    before = dm.launches_by_variant[plan[0]]
    y = dm.dequant_matmul(x, data, sc, bits=8, group_size=128, plan=plan)
    assert dm.launches_by_variant[plan[0]] == before + 1
    r = dm.dequant_matmul_plain(x, data, sc, bits=8, group_size=128)
    torch.testing.assert_close(y, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("plan", [("mma32", 1, 32), ("mma32", 4, 8),
                                  ("mma32", 3, 11), ("tiled", 1, 32)])
def test_float32_explicit_prefill_plan_close_to_plain(dev, plan):
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 1024, 4096, 8, 1, b=200,
                           dtype=torch.float32)
    before = dm.launches_by_variant[plan[0]]
    y = dm.dequant_matmul(x, data, sc, bits=8, group_size=128, plan=plan)
    assert dm.launches_by_variant[plan[0]] == before + 1
    r = dm.dequant_matmul_plain(x, data, sc, bits=8, group_size=128)
    torch.testing.assert_close(y, r, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("plan,b,dtype,n,gs", [
    (("tcgemv32", 1, 8), 8, torch.bfloat16, 1024, 128),   # bf16 x
    (("tcgemv", 1, 8), 8, torch.float32, 1024, 128),      # float32 x
    (("tcgemv32", 1, 8), 17, torch.float32, 1024, 128),   # B > 16
    (("tcgemv32", 1, 32), 8, torch.float32, 1024, 32),    # group < k-range
    (("tcgemv32", 2, 2), 8, torch.float32, 1024, 128),    # misses groups
    (("mma32", 1, 8), 64, torch.bfloat16, 1024, 128),
    (("mma", 1, 8), 64, torch.float32, 1024, 128),
    (("mma32", 1, 16), 64, torch.float32, 1024, 64),      # groups of 64
    (("mma32", 2, 2), 64, torch.float32, 1024, 128),
])
def test_float32_explicit_plan_refused(dev, plan, b, dtype, n, gs):
    """A launch the instance cannot take raises; nothing hands it to gemv,
    tiled or the plain version."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 256, n, 8, n // gs if gs < 128 else 1, b=b,
                           dtype=dtype)
    before = dict(dm.launches_by_variant)
    with pytest.raises(RuntimeError):
        dm.dequant_matmul(x, data, sc, bits=8, group_size=gs, plan=plan)
    assert dm.launches_by_variant == before


@pytest.mark.parametrize("b,want", [(8, "gemv"), (64, "tiled")])
def test_float32_leftovers_stay_on_cuda_cores(dev, b, want):
    """What the float32 instances cannot take -- x or codes off 16 bytes,
    N that is not a whole number of k-ranges (a ragged row) -- takes the
    CUDA-core variants, and the explicit tensor-core plan is refused."""
    from repro_torch.kernels import dequant_matmul as dm
    m, n = 256, 1024
    x, data, sc = _dm_case(dev, m, n, 8, 1, b=b, dtype=torch.float32)
    buf = torch.empty(b * n + 8, dtype=torch.float32, device=dev)
    xv = buf[1:1 + b * n].view(b, n)
    xv.copy_(x)
    _dm_check(xv, data, sc, 8, 128, want)
    with pytest.raises(RuntimeError):
        dm.dequant_matmul(xv, data, sc, bits=8, group_size=128,
                          plan=("tcgemv32" if b <= 16 else "mma32", 1,
                                n // 128))
    cbuf = torch.empty(m * n + 16, dtype=torch.int8, device=dev)
    cv = cbuf[8:8 + m * n].view(m, n)
    cv.copy_(data)
    _dm_check(x, cv, sc, 8, 128, want)
    xr, dr, sr = _dm_case(dev, m, 1000, 8, 1, b=b, dtype=torch.float32)
    _dm_check(xr, dr, sr, 8, 1000, want)


def test_wrappers_raise_instead_of_falling_back(dev):
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import squant_flip as sf
    w = torch.zeros(4, 512, device=dev)
    with pytest.raises(ValueError):
        sf.squant_flip(w, torch.ones(4, 1, device=dev), bits=4, group_size=256)
    with pytest.raises(ValueError):
        sf.squant_flip(w.double(), torch.ones(4, 1, device=dev), bits=4,
                       group_size=128)
    with pytest.raises(ValueError):
        dm.dequant_matmul(torch.zeros(2, 512, device=dev, dtype=torch.float16),
                          torch.zeros(4, 512, device=dev, dtype=torch.int8),
                          torch.ones(4, 1, device=dev), bits=8)


PREFILL_MN = [(1024, 4096), (4096, 4096), (12800, 4096), (4096, 12800)]


@pytest.mark.parametrize("m,n", PREFILL_MN)
@pytest.mark.parametrize("b", [17, 43, 64, 256, 384])
@pytest.mark.parametrize("bits", [8, 4])
def test_mma_main_path_shapes(dev, m, n, b, bits):
    """The prefill linears of granite-3-8b (admission chunks, round-path
    prefills, chunk tails): bf16 x, per-channel scales."""
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=b)
    _dm_check(x, data, sc, bits, 128, "mma")


@pytest.mark.parametrize("b", [17, 64, 300])
@pytest.mark.parametrize("bits", [8, 4])
def test_mma_group_scales(dev, b, bits):
    """Per-group scales (groups of 128): one m-tile per CTA, each group's
    partial times its scale."""
    m, n = 384, 2048
    x, data, sc = _dm_case(dev, m, n, bits, n // 128, b=b)
    _dm_check(x, data, sc, bits, 128, "mma")


@pytest.mark.parametrize("m", [100, 1000])
@pytest.mark.parametrize("b", [43, 200])
@pytest.mark.parametrize("bits", [8, 4])
def test_mma_ragged_rows(dev, m, b, bits):
    """M not a multiple of the 128-row tile and B not a multiple of the
    m-tile: TMA zero-fills the edge, the store masks it."""
    x, data, sc = _dm_case(dev, m, 1024, bits, 1, b=b)
    _dm_check(x, data, sc, bits, 128, "mma")


@pytest.mark.parametrize("m,n", [(1024, 4096), (4096, 12800)])
@pytest.mark.parametrize("b", [64, 384])
@pytest.mark.parametrize("bits", [8, 4])
def test_mma_deterministic(dev, m, n, b, bits):
    """Two launches give the same bits (split K merged in a fixed
    order)."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, m, n, bits, 1, b=b)
    _, splits, _ = dm.launch_plan(x, data, m, 1, 128, bits)
    assert splits > 1 or m == 12800
    y1 = dm.dequant_matmul(x, data, sc, bits=bits, group_size=128)
    y2 = dm.dequant_matmul(x, data, sc, bits=bits, group_size=128)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("plan", [("mma", 1, 32), ("mma", 4, 8),
                                  ("mma", 32, 1), ("mma", 3, 11)])
@pytest.mark.parametrize("b", [64, 200])
def test_mma_explicit_plan_close_to_plain(dev, plan, b):
    """Plans given to the wrapper (no split, even and uneven splits, one
    unit a split) run as given, within the bf16 tolerance of the plain
    version."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 1024, 4096, 8, 1, b=b)
    before = dm.launches_by_variant["mma"]
    y = dm.dequant_matmul(x, data, sc, bits=8, group_size=128, plan=plan)
    assert dm.launches_by_variant["mma"] == before + 1
    r = dm.dequant_matmul_plain(x, data, sc, bits=8, group_size=128)
    torch.testing.assert_close(y.float(), r.float(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("plan", [("mma", 2, 8), ("mma", 2, 32),
                                  ("mma", 0, 32), ("mma", 33, 1)])
def test_mma_explicit_plan_refused(dev, plan):
    """Splits that miss units, hold none or no split at all are
    refused."""
    from repro_torch.kernels import dequant_matmul as dm
    x, data, sc = _dm_case(dev, 1024, 4096, 8, 1, b=64)
    with pytest.raises(RuntimeError):
        dm.dequant_matmul(x, data, sc, bits=8, group_size=128, plan=plan)


def test_mma_refuses_misaligned_x(dev):
    """x that does not start on 16 bytes: the mma launch is refused with an
    error, and the rule names tiled for it (counted as tiled), never mma."""
    from repro_torch.kernels import dequant_matmul as dm
    b, m, n = 64, 256, 1024
    x, data, sc = _dm_case(dev, m, n, 8, 1, b=b)
    buf = torch.empty(b * n + 8, dtype=torch.bfloat16, device=dev)
    xv = buf[1:1 + b * n].view(b, n)
    xv.copy_(x)
    with pytest.raises(RuntimeError):
        dm.dequant_matmul(xv, data, sc, bits=8, group_size=128,
                          plan=("mma", 1, n // 128))
    _dm_check(xv, data, sc, 8, 128, "tiled")


def _paged_case(dev, b, kv, rep, d, bs, nb, lengths, dtype, quant, seed=0,
                poison=True):
    """Pools with two spare blocks (trash block 0 included), each slot's
    blocks distinct, table entries past a slot's length pointing at the
    trash block, and (``poison``) every pool position no slot reads
    unmasked poisoned with +1e6 (codes at +127, scales 1e6 for the int8
    pool). The same seed draws the same live values either way."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = b * nb + 2
    perm = torch.randperm(n - 1, generator=g)[:b * nb] + 1
    bt = perm.reshape(b, nb).to(torch.int32)
    live = torch.zeros(n, bs, dtype=torch.bool)
    for i, L in enumerate(lengths):
        used = L // bs + 1
        bt[i, used:] = 0
        cols = torch.arange(L + 1)
        live[bt[i, cols // bs].long(), cols % bs] = True
    q = torch.randn(b, kv * rep, d, generator=g).to(dtype)
    if quant:
        from repro_torch.models.attention import _quant_tok
        kq, ks = _quant_tok(torch.randn(n, bs, kv, d, generator=g))
        vq, vs = _quant_tok(torch.randn(n, bs, kv, d, generator=g))
        if poison:
            dead = ~live
            kq[dead] = 127
            vq[dead] = 127
            ks[dead] = 1e6
            vs[dead] = 1e6
        pools = [kq, vq, ks, vs]
    else:
        k = torch.randn(n, bs, kv, d, generator=g)
        v = torch.randn(n, bs, kv, d, generator=g)
        if poison:
            k[~live] += 1e6
            v[~live] += 1e6
        pools = [k.to(dtype), v.to(dtype)]
    ln = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(dev) for t in [q] + pools + [bt, ln]]


PAGED_CASES = {
    # the main path's shape (granite-3-8b: H=32, KV=8, D=128), bs=16, nb=32
    "main": dict(b=8, kv=8, rep=4, d=128, bs=16, nb=32,
                 lengths=[0, 5, 15, 16, 100, 255, 300, 511]),
    # ragged: rep=1, D=64, lengths {0, bs-1, bs, full}
    "ragged": dict(b=4, kv=2, rep=1, d=64, bs=16, nb=4,
                   lengths=[0, 15, 16, 63]),
    # minitron-4b: H=24, KV=8 (rep 3), D=128
    "rep3": dict(b=4, kv=8, rep=3, d=128, bs=16, nb=32,
                 lengths=[0, 17, 200, 511]),
    # gemma-7b: H=KV=16 (rep 1), D=256
    "d256": dict(b=3, kv=16, rep=1, d=256, bs=16, nb=16,
                 lengths=[0, 100, 255]),
    # long contexts: nb=256, many splits of many blocks
    "long": dict(b=8, kv=8, rep=4, d=128, bs=16, nb=256,
                 lengths=[1500, 2047, 2048, 3000, 3500, 4000, 4094, 4095]),
    # one slot: the split axis alone fills the card
    "single": dict(b=1, kv=8, rep=4, d=128, bs=16, nb=32, lengths=[400]),
    "bs8": dict(b=4, kv=2, rep=4, d=64, bs=8, nb=16, lengths=[0, 7, 8, 127]),
    "bs32": dict(b=4, kv=2, rep=2, d=128, bs=32, nb=8,
                 lengths=[0, 31, 32, 255]),
    # reduced configs' D=16; D=24 takes 8-byte int8 vectors; rep 5 and 12
    # take one and several head groups
    "d16": dict(b=3, kv=2, rep=2, d=16, bs=4, nb=8, lengths=[0, 3, 31]),
    "d24rep5": dict(b=2, kv=2, rep=5, d=24, bs=16, nb=4, lengths=[10, 63]),
    "rep12": dict(b=2, kv=1, rep=12, d=64, bs=16, nb=4, lengths=[5, 63]),
}


@pytest.mark.parametrize("case", sorted(PAGED_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_kernels_close_to_plain(dev, case, dtype, quant):
    """Kernel C (model-dtype pool) and kernel D (int8 pool) against their
    plain versions: float32 within 2e-5, bfloat16 within 2e-2 (the plain
    version rounds its products to bfloat16 where the kernel keeps
    float32). The poisoned positions must not leak into either."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    c = PAGED_CASES[case]
    args = _paged_case(dev, c["b"], c["kv"], c["rep"], c["d"], c["bs"],
                       c["nb"], c["lengths"], dtype, quant)
    scale = c["d"] ** -0.5
    mod, fn, plain = (paq, paq.paged_attention_quant,
                      paq.paged_attention_quant_plain) if quant else \
        (pa, pa.paged_attention, pa.paged_attention_plain)
    before = mod.launches
    got = fn(*args, scale=scale)
    assert mod.launches == before + 1 and got.dtype == dtype
    want = plain(*args, scale=scale)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["ragged", "single", "long"])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_kernel_poisoned_tail_exact(dev, quant, case):
    """Poisoning every masked position — the trash block and the tails
    that point at it included — cannot change the kernel's output at all:
    masked columns, and splits wholly past a slot's length, contribute
    exact zeros."""
    from repro_torch.kernels import ops
    c = PAGED_CASES[case]
    shape = (c["b"], c["kv"], c["rep"], c["d"], c["bs"], c["nb"],
             c["lengths"], torch.float32, quant)
    clean = _paged_case(dev, *shape, seed=3, poison=False)
    dirty = _paged_case(dev, *shape, seed=3, poison=True)
    fn = ops.paged_attention_quant if quant else ops.paged_attention
    base = fn(*clean, scale=0.35)
    out = fn(*dirty, scale=0.35)
    torch.cuda.synchronize()
    assert torch.equal(out, base)


def test_paged_wrappers_raise_instead_of_falling_back(dev):
    from repro_torch.kernels import paged_attention as pa
    q = torch.zeros(2, 4, 64, device=dev)
    pool = torch.zeros(3, 16, 2, 64, device=dev)
    bt = torch.zeros(2, 1, dtype=torch.int32, device=dev)
    ln = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool.bfloat16(), pool.bfloat16(), bt, ln,
                           scale=1.0)
    with pytest.raises(ValueError):
        pa.paged_attention(q, pool, pool, bt.long(), ln, scale=1.0)


@pytest.mark.parametrize("case", ["main", "long"])
@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_kernels_deterministic(dev, case, quant):
    """Two launches on the same inputs give the same output bits: the
    splits are merged in a fixed order, with no atomics."""
    from repro_torch.kernels import ops
    c = PAGED_CASES[case]
    args = _paged_case(dev, c["b"], c["kv"], c["rep"], c["d"], c["bs"],
                       c["nb"], c["lengths"], torch.bfloat16, quant)
    fn = ops.paged_attention_quant if quant else ops.paged_attention
    first = fn(*args, scale=0.1)
    second = fn(*args, scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_wrappers_refuse_head_dim_not_multiple_of_8(dev, quant):
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import paged_attention_quant as paq
    c = dict(PAGED_CASES["ragged"], d=12)
    args = _paged_case(dev, c["b"], c["kv"], c["rep"], c["d"], c["bs"],
                       c["nb"], c["lengths"], torch.float32, quant)
    fn = paq.paged_attention_quant if quant else pa.paged_attention
    with pytest.raises(ValueError, match="multiple of 8"):
        fn(*args, scale=1.0)


# ---- kernel A on (in, out) leaves as they are stored -----------------------

NATIVE_SHAPES = [(4096, 4096), (4096, 1024), (4096, 12800), (12800, 4096),
                 (1000, 37), (1001, 33), (300, 16)]
STAGES = {"E": (False, False), "EK": (True, False), "EKC": (True, True)}


def _grid_leaves(dev, kin, nch, bits, b, seed=0):
    """Weights on a binary grid with a power-of-two scale: every float32 sum
    of the flip is exact in any order, so codes must be equal bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    leaves = [torch.randint(-400, 401, (kin, nch), generator=gen,
                            device=dev).float() / 64 for _ in range(b)]
    s = torch.full((b, nch), 0.5 if bits >= 6 else 1.0, device=dev)
    return leaves, s


def _native_check(leaves, s, **kw):
    """One launch of the instance the route rule names; codes equal the
    plain version's."""
    from repro_torch.kernels import squant_flip as sf
    nch = leaves[0].shape[1]
    want_route = sf.route(nch, all(l.data_ptr() % 16 == 0 for l in leaves))
    before, by = sf.launches, sf.launches_by_route[want_route]
    got = sf.squant_flip_leaves(leaves, s, **kw)
    assert sf.launches == before + 1
    assert sf.launches_by_route[want_route] == by + 1
    want = sf.squant_flip_leaves_plain(leaves, s, **kw)
    assert got.shape == want.shape == (len(leaves), nch, leaves[0].shape[0])
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("kin,nch", NATIVE_SHAPES)
@pytest.mark.parametrize("g", [128, 64, 12])
@pytest.mark.parametrize("stage", sorted(STAGES))
@pytest.mark.parametrize("bits", [8, 4])
def test_native_flip_exact_inputs_equal_plain(dev, kin, nch, g, stage, bits):
    ek, ec = STAGES[stage]
    b = 2 if kin * nch < 4096 * 4096 else 1
    leaves, s = _grid_leaves(dev, kin, nch, bits, b)
    _native_check(leaves, s, bits=bits, group_size=g, enable_k=ek,
                  enable_c=ec)


@pytest.mark.parametrize("bits", [2, 3, 5, 6, 7])
@pytest.mark.parametrize("kin,nch,g", [(1001, 33, 12), (4096, 1024, 128),
                                       (300, 16, 64)])
def test_native_flip_all_bit_widths(dev, bits, kin, nch, g):
    leaves, s = _grid_leaves(dev, kin, nch, bits, 2)
    for ek, ec in STAGES.values():
        _native_check(leaves, s, bits=bits, group_size=g, enable_k=ek,
                      enable_c=ec)


@pytest.mark.parametrize("kin,nch", [(4096, 4096), (12800, 4096), (1000, 37)])
def test_native_flip_random_inputs_tie_rule(dev, kin, nch):
    """Normal weights through the max scales: rows may differ only where a
    float32 tie of the plain version's own sums explains it."""
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.kernels.ref import explain_code_differences
    gen = torch.Generator(device=dev).manual_seed(1)
    w = torch.randn((kin, nch), generator=gen, device=dev)
    s = sf.squant_scales([w], 8)
    kw = dict(bits=8, group_size=128)
    got = sf.squant_flip_leaves([w], s, **kw)[0]
    want = sf.squant_flip_leaves_plain([w], s, **kw)[0]
    res = explain_code_differences(w.T, s[0], got, want, **kw)
    assert res["unexplained"] == 0, res


@pytest.mark.parametrize("bits", [4, 8])
def test_native_flip_heavy_clipping(dev, bits):
    gen = torch.Generator(device=dev).manual_seed(2)
    leaves = [torch.round(torch.randn((1024, 64), generator=gen, device=dev)
                          * 64) / 16 for _ in range(3)]
    s = torch.full((3, 64), 0.5, device=dev)
    _native_check(leaves, s, bits=bits, group_size=128)


@pytest.mark.parametrize("kin,nch", [(4096, 4096), (1001, 33)])
def test_native_flip_deterministic(dev, kin, nch):
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(3)
    leaves = [torch.randn((kin, nch), generator=gen, device=dev)
              for _ in range(2)]
    s = sf.squant_scales(leaves, 8)
    first = sf.squant_flip_leaves(leaves, s, bits=8, group_size=128)
    second = sf.squant_flip_leaves(leaves, s, bits=8, group_size=128)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("kin,nch", NATIVE_SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
def test_native_scales_bit_identical_to_dispatch(dev, kin, nch, bits):
    from repro_torch.core.dispatch import _scales
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(4)
    leaves = [torch.randn((kin, nch), generator=gen, device=dev)
              * (i + 0.5) for i in range(2)]
    leaves[1][:, 1] = 0.0                 # an all-zero channel: the eps clamp
    before = sf.scale_launches
    got = sf.squant_scales(leaves, bits)
    assert sf.scale_launches == before + 1
    want = _scales(torch.stack([l.T for l in leaves]), bits, "max")[..., 0]
    assert torch.equal(got, want)


def test_native_flip_table_of_more_leaves_than_one_launch_takes(dev):
    from repro_torch.kernels import squant_flip as sf
    n = sf.MAX_LEAVES + 5
    leaves, s = _grid_leaves(dev, 256, 8, 8, n)
    before = sf.launches
    got = sf.squant_flip_leaves(leaves, s, bits=8, group_size=128)
    assert sf.launches == before + 2          # tables of MAX_LEAVES
    assert torch.equal(got, sf.squant_flip_leaves_plain(leaves, s, bits=8,
                                                        group_size=128))


def test_row_major_entry_reads_a_transposed_view(dev):
    from repro_torch.kernels import squant_flip as sf
    leaves, s = _grid_leaves(dev, 1001, 36, 8, 1)
    got = sf.squant_flip(leaves[0].T, s[0, :, None], bits=8, group_size=128)
    assert torch.equal(got, sf.squant_flip_plain(leaves[0].T, s[0, :, None],
                                                 bits=8, group_size=128))


def test_native_wrappers_refuse_what_they_would_copy(dev):
    from repro_torch.kernels import squant_flip as sf
    w = torch.zeros(256, 64, device=dev)
    s = torch.ones(1, 64, device=dev)
    for bad in (w.T.contiguous().T, w.bfloat16()):
        with pytest.raises(ValueError):
            sf.squant_flip_leaves([bad], s, bits=8, group_size=128)
        with pytest.raises(ValueError):
            sf.squant_scales([bad], 8)
    with pytest.raises(ValueError):
        sf.squant_flip_leaves([w, torch.zeros(256, 32, device=dev)], s,
                              bits=8, group_size=128)


def test_quantize_tree_on_the_card_native_route(dev, monkeypatch):
    """The whole pipeline on the card: one device sync, one kernel-A launch
    and one scale pass per native bucket (expert banks included, each
    expert's slice read where it is stored), the stacked route for the conv
    leaf, codes and scales equal to the plain tree's."""
    from repro_torch.core import pipeline
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(5)

    def w(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    tree = {"a": {"w": w(512, 64)}, "b": {"w": w(512, 64)},
            "odd": {"w": w(1001, 33)}, "small": {"w": w(300, 16)},
            "moe": {"w": w(2, 256, 8)}, "conv": {"w_conv": w(3, 3, 4, 8)}}
    syncs = []
    real = pipeline._sync
    monkeypatch.setattr(pipeline, "_sync",
                        lambda d: (syncs.append(1), real(d))[1])
    n0, s0 = sf.launches, sf.scale_launches
    got, rep = pipeline.quantize_tree(tree, bits=8, group_size=128,
                                      device=dev)
    assert len(syncs) == 1
    routes = {b.key: b.route for b in rep.buckets}
    assert routes == {"(64,512)x2 float32 g128": "native",
                      "(33,1001)x1 float32 g128": "native",
                      "(16,300)x1 float32 g128": "native",
                      "(16,256)x1 float32 g128": "native",
                      "(8,36)x1 float32 g9": "stacked"}
    assert sf.scale_launches - s0 == 4
    assert sf.launches - n0 == 5 == len(rep.buckets)
    want, _ = pipeline.quantize_tree(tree, bits=8, group_size=128,
                                     device=dev, backend="ref")
    for k in tree:
        a = got[k]["w_conv" if k == "conv" else "w"]
        b = want[k]["w_conv" if k == "conv" else "w"]
        assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
