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
