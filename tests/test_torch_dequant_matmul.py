"""Port vs reference: the dequant-matmul plain version against the Pallas
kernel in interpret mode and ``dequant_matmul_ref`` — int8/int4, per-channel
and per-group scales; float32 within 1e-4, bfloat16 within 2e-2 (the
tolerances the reference holds its own kernel to)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro_torch.core.squant import SQuantConfig, squant
from repro_torch.kernels import ops
from repro_torch.kernels import dequant_matmul as dm
from repro_torch.kernels import ref as tref
from repro_torch.quant.qtypes import pack_int4

# small shapes: one thread a process, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _quant(rng, m, n, bits, group_scales, g):
    codes = rng.integers(-(2 ** (bits - 1) - 1), 2 ** (bits - 1),
                         size=(m, n)).astype(np.int8)
    shape = (m, n // g) if group_scales else (m, 1)
    scale = rng.uniform(0.01, 0.1, size=shape).astype(np.float32)
    data = pack_int4(torch.from_numpy(codes)).numpy() if bits <= 4 else codes
    return data, scale, codes


@pytest.mark.parametrize("b,m,n,g", [
    (8, 16, 64, 32), (4, 32, 128, 32), (16, 8, 256, 64), (2, 128, 128, 128),
    (1, 4, 32, 32), (24, 8, 96, 32)])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("group_scales", [False, True])
def test_matches_pallas_interpret_and_ref(rng, b, m, n, g, bits, group_scales):
    data, scale, codes = _quant(rng, m, n, bits, group_scales, g)
    x = rng.normal(size=(b, n)).astype(np.float32)
    got = dm.dequant_matmul(torch.from_numpy(x), torch.from_numpy(data),
                            torch.from_numpy(scale), bits=bits, group_size=g)
    kern = dequant_matmul_pallas(jnp.asarray(x), jnp.asarray(data),
                                 jnp.asarray(scale), bits=bits, group_size=g,
                                 tb=min(8, b), tm=min(8, m), interpret=True)
    want = jref.dequant_matmul_ref(jnp.asarray(x), jnp.asarray(data),
                                   jnp.asarray(scale), bits=bits,
                                   group_size=g)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    # and against the definition
    s = np.repeat(scale, n // scale.shape[1], axis=1)
    dense = x @ (codes.astype(np.float32) * s).T
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bits", [4, 8])
def test_bf16_activations(rng, bits):
    data, scale, _ = _quant(rng, 16, 64, bits, False, 32)
    x = rng.normal(size=(8, 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tref.dequant_matmul_ref(xt, torch.from_numpy(data),
                                  torch.from_numpy(scale), bits=bits,
                                  group_size=32)
    assert got.dtype == torch.bfloat16
    want = jref.dequant_matmul_ref(jnp.asarray(x).astype(jnp.bfloat16),
                                   jnp.asarray(data), jnp.asarray(scale),
                                   bits=bits, group_size=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("bits,gs,n", [(4, 32, 128), (8, 128, 256),
                                       (8, 128, 96)])
def test_ops_on_quantized_tensor(rng, bits, gs, n):
    """``ops.dequant_matmul`` on a QuantizedTensor; N % 128 != 0 makes the
    whole row one tile (``gs = N``)."""
    w = rng.normal(size=(32, n)).astype(np.float32)
    qt, _ = squant(torch.from_numpy(w), SQuantConfig(bits=bits, group_size=gs))
    x = rng.normal(size=(8, n)).astype(np.float32)
    dense = x @ qt.dequantize().numpy().T
    for backend in ("auto", "ref"):
        y = ops.dequant_matmul(torch.from_numpy(x), qt, backend=backend)
        np.testing.assert_allclose(y.numpy(), dense, rtol=1e-4, atol=1e-4)


def test_shape_checks():
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError):
        dm.dequant_matmul(x, torch.zeros(4, 8, dtype=torch.int8),
                          torch.ones(4, 1), bits=8, group_size=16)
    with pytest.raises(ValueError):
        dm.dequant_matmul(x, torch.zeros(4, 16, dtype=torch.int8),
                          torch.ones(4, 1), bits=8, group_size=5)
    with pytest.raises(ValueError):
        dm.dequant_matmul(x, torch.zeros(4, 16, dtype=torch.int8),
                          torch.ones(4, 3), bits=8, group_size=8)
