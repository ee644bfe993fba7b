"""Port vs reference: packing, QuantizedTensor, scales — same numpy inputs
through both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import qtypes as jq
from repro.quant import scales as js
from repro_torch.quant import qtypes as tq
from repro_torch.quant import scales as ts

from conftest import grid_weights

# small shapes: one thread a process, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(4, 8), (3, 5, 16), (1, 2)])
def test_pack_unpack_round_trip_and_equal(rng, shape):
    codes = rng.integers(-8, 8, size=shape).astype(np.int8)
    pj = np.asarray(jq.pack_int4(jnp.asarray(codes)))
    pt = tq.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tq.unpack_int4(pt).numpy(), codes)
    np.testing.assert_array_equal(
        tq.unpack_int4(pt).numpy(), np.asarray(jq.unpack_int4(jnp.asarray(pj))))


def test_pack_rejects_odd():
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros(2, 3, dtype=torch.int8))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("n", [16, 15])
def test_from_codes_matches_reference(rng, bits, n):
    qmax = tq.qmax_for_bits(bits)
    assert qmax == jq.qmax_for_bits(bits)
    codes = rng.integers(-qmax, qmax + 1, size=(6, n)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, size=(6, 1)).astype(np.float32)
    a = jq.from_codes(jnp.asarray(codes), jnp.asarray(scale), bits)
    b = tq.from_codes(torch.from_numpy(codes), torch.from_numpy(scale), bits)
    assert b.packed == a.packed == (bits <= 4)      # every bits<=4 is packed
    assert b.shape == a.shape and b.nbytes() == a.nbytes()
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    np.testing.assert_array_equal(b.codes().numpy(), codes)
    np.testing.assert_array_equal(b.dequantize().numpy(),
                                  np.asarray(a.dequantize()))


def test_dequantize_grouped(rng):
    codes = rng.integers(-7, 8, size=(4, 32)).astype(np.int8)
    scale = rng.uniform(0.01, 0.1, size=(4, 4)).astype(np.float32)
    a = jq.from_codes(jnp.asarray(codes), jnp.asarray(scale), 4, group_size=8)
    b = tq.from_codes(torch.from_numpy(codes), torch.from_numpy(scale), 4,
                      group_size=8)
    np.testing.assert_array_equal(b.dequantize().numpy(),
                                  np.asarray(a.dequantize()))


def test_qmax_range():
    with pytest.raises(ValueError):
        tq.qmax_for_bits(1)


def test_report_summary_matches():
    kw = dict(total_millis=12.5, method="squant", bits=4, backend="ref",
              dispatch_millis=10.0, sync_millis=2.5)
    a = jq.QuantReport([jq.LayerReport("a/w", (2, 3), 1.0, "squant", 4)],
                       buckets=[jq.BucketReport("k", 1, 1.0)], **kw)
    b = tq.QuantReport([tq.LayerReport("a/w", (2, 3), 1.0, "squant", 4)],
                       buckets=[tq.BucketReport("k", 1, 1.0)], **kw)
    assert a.summary() == b.summary()


@pytest.mark.parametrize("bits", [3, 4, 8])
@pytest.mark.parametrize("gs", [None, 32])
def test_max_scale_bit_equal(rng, bits, gs):
    for w in (rng.normal(size=(16, 128)).astype(np.float32),
              grid_weights(rng, 16, 128)):
        a = js.compute_scale(jnp.asarray(w), bits, "max", gs)
        b = ts.compute_scale(torch.from_numpy(w), bits, "max", gs)
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_max_scale_zero_row_floor():
    w = np.zeros((2, 8), np.float32)
    np.testing.assert_array_equal(
        ts.max_scale(torch.from_numpy(w), 4).numpy(),
        np.asarray(js.max_scale(jnp.asarray(w), 4)))


@pytest.mark.parametrize("bits", [4, 8])
def test_mse_scale(rng, bits):
    w = grid_weights(rng, 8, 64)
    a = js.mse_scale(jnp.asarray(w), bits)
    b = ts.mse_scale(torch.from_numpy(w), bits)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    w = rng.normal(size=(8, 64)).astype(np.float32)
    a = js.mse_scale(jnp.asarray(w), bits)
    b = ts.mse_scale(torch.from_numpy(w), bits)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)


def test_default_mse_grid_is_the_reference_grid_bit_for_bit():
    """The default clip-ratio grid equals ``jnp.linspace(0.4, 1.0, 40)``
    bit for bit (``torch.linspace`` does not); another grid is
    ``torch.linspace``'s."""
    want = np.asarray(jnp.linspace(0.4, 1.0, 40)).view(np.uint32)
    got = ts.mse_grid().numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert ts.mse_grid().dtype == torch.float32
    torch.testing.assert_close(ts.mse_grid(0.5, 11),
                               torch.linspace(0.5, 1.0, 11), rtol=0, atol=0)


def test_compute_scale_rejects_ragged_groups():
    with pytest.raises(ValueError):
        ts.compute_scale(torch.zeros(2, 10), 4, "max", 4)
