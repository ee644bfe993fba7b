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
        for j in range(used):
            for o in range(bs):
                if j * bs + o <= L:
                    live[int(bt[i, j]), o] = True
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


@pytest.mark.parametrize("quant", [False, True])
def test_paged_attention_kernel_poisoned_tail_exact(dev, quant):
    """Poisoning every masked position — the trash block and the tails
    that point at it included — cannot change the kernel's output at all:
    masked columns contribute exact zeros."""
    from repro_torch.kernels import ops
    c = PAGED_CASES["ragged"]
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
