"""Port vs reference: the SQuant core (the plain version of the flip kernel)
against ``repro.core.squant.squant_codes``, the Pallas kernel in interpret
mode, and the sequential NumPy transcription of Algorithms 1-4.

Two kinds of comparison:
(i)  exact inputs — ``grid_weights`` with a power-of-two scale, so ``w/s``,
     δ and every partial sum are exact in float32 in any order →
     ``array_equal``, no exceptions;
(ii) random normal weights through ``compute_scale`` → rows that differ are
     counted and each must be explained by a tie and keep the paper's
     invariants (``explain_code_differences``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.reference import squant_reference
from repro.core.squant import squant_codes as jax_squant_codes
from repro.kernels import ops as jax_ops
from repro_torch.core.squant import SQuantConfig, squant, squant_codes
from repro_torch.kernels import ops
from repro_torch.kernels.ref import explain_code_differences
from repro_torch.quant.scales import compute_scale

from conftest import grid_weights

# small shapes: one thread a process, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

STAGES = [(False, False), (True, False), (True, True), (False, True)]
SHAPES = [(8, 128, 32), (16, 256, 64), (5, 96, 32), (8, 100, 32),
          (3, 50, 16), (1, 16, 16), (8, 512, 128), (6, 64, None)]


def _both(w, scale, bits, gs, ek, ec):
    a, _, _ = jax_squant_codes(jnp.asarray(w), jnp.asarray(scale), bits=bits,
                               group_size=gs, enable_k=ek, enable_c=ec)
    b, delta, stats = squant_codes(torch.from_numpy(w),
                                   torch.from_numpy(scale), bits=bits,
                                   group_size=gs, enable_k=ek, enable_c=ec)
    return np.asarray(a), b.numpy(), delta, stats


@pytest.mark.parametrize("m,n,gs", SHAPES)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ek,ec", STAGES)
def test_exact_inputs_equal_jax_and_numpy(rng, m, n, gs, bits, ek, ec):
    w = grid_weights(rng, m, n)
    scale = np.full((m, 1), 2.0 ** (-1 if bits == 8 else 0), np.float32)
    a, b, _, _ = _both(w, scale, bits, gs, ek, ec)
    np.testing.assert_array_equal(b, a)
    want, _, _ = squant_reference(w, scale, bits, gs, ek, ec)
    np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("m,n,gs", [s for s in SHAPES if s[2] is not None])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("ek,ec", STAGES[:3])
def test_random_inputs_tie_rule(rng, m, n, gs, bits, ek, ec):
    w = rng.normal(size=(m, n)).astype(np.float32)
    scale = compute_scale(torch.from_numpy(w), bits).numpy()
    a, b, _, _ = _both(w, scale, bits, gs, ek, ec)
    res = explain_code_differences(
        torch.from_numpy(w), torch.from_numpy(scale), torch.from_numpy(b),
        torch.tensor(a), bits=bits, group_size=gs, enable_k=ek,
        enable_c=ec)
    assert res["unexplained"] == 0, res
    # found on these seeds: no row differs
    assert res["rows_differing"] <= max(1, m // 4), res


@pytest.mark.parametrize("ek,ec", STAGES[:3])
def test_matches_pallas_interpret(rng, ek, ec):
    """The reference's kernel body, run as its own tests run it on the CPU."""
    w = grid_weights(rng, 12, 160)
    scale = np.full((12, 1), 1.0, np.float32)
    got = ops.squant_flip(torch.from_numpy(w), torch.from_numpy(scale), bits=4,
                          group_size=32, enable_k=ek, enable_c=ec)
    want = jax_ops.squant_flip(jnp.asarray(w), jnp.asarray(scale), bits=4,
                               group_size=32, enable_k=ek, enable_c=ec,
                               use_pallas="interpret")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("ek,ec", STAGES)
def test_heavy_clipping(rng, ek, ec):
    w = (rng.integers(-400, 401, size=(8, 128)) / 16.0).astype(np.float32)
    scale = np.full((8, 1), 0.5, np.float32)          # codes pile up at ±qmax
    a, b, _, _ = _both(w, scale, 4, 32, ek, ec)
    np.testing.assert_array_equal(b, a)
    assert b.max() <= 7 and b.min() >= -7
    want, _, _ = squant_reference(w, scale, 4, 32, ek, ec)
    np.testing.assert_array_equal(b, want)


def test_batched_flattening_equals_per_matrix(rng):
    w3 = np.stack([grid_weights(rng, 6, 64) for _ in range(3)])
    s3 = np.full((3, 6, 1), 1.0, np.float32)
    got = ops.squant_flip_batched(torch.from_numpy(w3), torch.from_numpy(s3),
                                  bits=4, group_size=16)
    for i in range(3):
        one = ops.squant_flip(torch.from_numpy(w3[i]), torch.from_numpy(s3[i]),
                              bits=4, group_size=16)
        np.testing.assert_array_equal(got[i].numpy(), one.numpy())
    whole = ops.squant_flip_batched(torch.from_numpy(w3),
                                    torch.from_numpy(s3), bits=4,
                                    group_size=None)
    want = jax_ops.squant_flip_batched(jnp.asarray(w3), jnp.asarray(s3),
                                       bits=4, group_size=None)
    np.testing.assert_array_equal(whole.numpy(), np.asarray(want))


def test_conv_layout_and_group_clamp(rng):
    from repro.core.squant import SQuantConfig as JCfg, squant as jsquant
    w = grid_weights(rng, 4, 6 * 9).reshape(4, 6, 9)
    scale = np.full((4, 1), 1.0, np.float32)
    qa, sa = jsquant(jnp.asarray(w), JCfg(bits=4), jnp.asarray(scale))
    qb, sb = squant(torch.from_numpy(w), SQuantConfig(bits=4),
                    torch.from_numpy(scale))
    assert sb["group_size"] == sa["group_size"] == 9
    np.testing.assert_array_equal(qb.codes().numpy(), np.asarray(qa.codes()))
    w2 = grid_weights(rng, 4, 64)
    _, s2 = squant(torch.from_numpy(w2), SQuantConfig(bits=4, group_size=128),
                   torch.from_numpy(scale))
    assert s2["group_size"] is None                 # group >= row: FC path
    with pytest.raises(ValueError):
        squant(torch.zeros(3), SQuantConfig())


@pytest.mark.parametrize("bits", [3, 4, 6, 8])
@pytest.mark.parametrize("gs", [None, 32, 128])
def test_invariants(rng, bits, gs):
    w = rng.normal(size=(24, 256)).astype(np.float32)
    qt, stats = squant(torch.from_numpy(w), SQuantConfig(bits=bits,
                                                         group_size=gs))
    codes = qt.codes().numpy().astype(np.float64)
    d = codes - w.astype(np.float64) / qt.scale.numpy().astype(np.float64)
    assert np.abs(d).max() < 1.0 + 1e-4
    assert np.abs(d.sum(axis=1)).max() <= 0.5 + 1e-4
    if gs is not None and gs < 256:
        assert np.abs(d.reshape(24, -1, gs).sum(-1)).max() <= 1.0 + 1e-4
    q = 2 ** (bits - 1) - 1
    assert codes.max() <= q and codes.min() >= -q
    assert float(stats["max_abs_delta"]) < 1.0 + 1e-4
    assert SQuantConfig(bits=bits, group_size=gs).tag().startswith("squant-EKC")
