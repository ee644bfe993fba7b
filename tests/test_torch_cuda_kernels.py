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
    """float32 x keeps gemv (never rounded to bf16 or TF32): 1e-4."""
    x, data, sc = _dm_case(dev, m, n, 8, 1, b=b, dtype=torch.float32)
    _dm_check(x, data, sc, 8, 128, "gemv")


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
