"""Port vs reference: ``core/baselines`` (RTN, DFQ equalization and bias
correction, ZeroQ-style input synthesis, AdaRound).

The reference's own cases (``tests/test_baselines.py``) run on the port;
``rtn`` codes and scales are bit-identical to the reference's under the
max scale (the MSE scale within 1e-6), ``equalize_pair`` and
``bias_correction`` within 1e-6, and ``adaround``'s codes equal the
reference's on at least 97 % of elements with an output MSE no worse than
the reference's by more than 1 %."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro_torch.core import baselines as tb
from repro_torch.quant.scales import compute_scale


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_rtn_matches_manual(rng):
    w = rng.normal(size=(8, 64)).astype(np.float32)
    qt = tb.rtn(_t(w), bits=4)
    s = qt.scale.numpy()
    np.testing.assert_array_equal(qt.codes().numpy(),
                                  np.clip(np.round(w / s), -7, 7))


def test_mse_scale_beats_max_scale_on_outliers(rng):
    w = rng.normal(size=(16, 512)).astype(np.float32)
    w[:, 0] *= 30.0
    wt = _t(w)
    for bits in (3, 4):
        qmax = 2 ** (bits - 1) - 1

        def err(s):
            q = torch.clamp(torch.round(wt / s), -qmax, qmax)
            return float(torch.mean((q * s - wt) ** 2))

        assert err(compute_scale(wt, bits, "mse")) < \
            err(compute_scale(wt, bits, "max"))


def test_equalization_preserves_function(rng):
    w1 = rng.normal(size=(32, 16)).astype(np.float32)
    w2 = rng.normal(size=(8, 32)).astype(np.float32)
    x = rng.normal(size=(64, 16)).astype(np.float32)
    e1, e2, _ = tb.equalize_pair(_t(w1), _t(w2))
    y0 = w2 @ np.maximum(w1 @ x.T, 0)
    y1 = e2.numpy() @ np.maximum(e1.numpy() @ x.T, 0)
    np.testing.assert_allclose(y1, y0, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.abs(e1.numpy()).max(1),
                               np.abs(e2.numpy()).max(0), rtol=1e-3)


def test_equalization_reduces_rtn_error(rng):
    w1 = rng.normal(size=(32, 16)).astype(np.float32)
    w1 *= np.logspace(-2, 1, 32)[:, None].astype(np.float32)
    w2 = rng.normal(size=(8, 32)).astype(np.float32)
    x = rng.normal(size=(128, 16)).astype(np.float32)
    y_ref = np.maximum(w1 @ x.T, 0).T @ w2.T

    def pt(a):
        s = float(np.abs(a).max() / 7.0)
        return np.clip(np.round(a / s), -7, 7) * s

    def quant_err(a, b):
        y = np.maximum(pt(a) @ x.T, 0).T @ pt(b).T
        return float(np.mean((y - y_ref) ** 2))

    e1, e2, _ = tb.equalize_pair(_t(w1), _t(w2))
    assert quant_err(e1.numpy(), e2.numpy()) < quant_err(w1, w2)


def test_bias_correction_zeroes_expected_shift(rng):
    w = rng.normal(size=(8, 32)).astype(np.float32)
    wq = tb.rtn(_t(w), bits=3).dequantize().numpy()
    mu = rng.normal(size=32).astype(np.float32)
    corr = tb.bias_correction(_t(w), _t(wq), _t(mu)).numpy()
    np.testing.assert_allclose((wq - w) @ mu + corr, 0.0, atol=1e-5)


def test_synthesize_inputs_matches_stats():
    target = torch.tensor([0.0, 1.0])

    def stat_fn(x):
        return torch.stack([torch.mean(x), torch.var(x, unbiased=False)])

    x = tb.synthesize_inputs(stat_fn, target, (32, 16),
                             torch.Generator().manual_seed(0), iters=200)
    s = stat_fn(x)
    assert abs(float(s[0])) < 0.05 and abs(float(s[1]) - 1.0) < 0.1


@pytest.mark.slow
def test_adaround_beats_rtn_on_output_mse(rng):
    w = rng.normal(size=(16, 64)).astype(np.float32)
    x = rng.normal(size=(128, 64)).astype(np.float32)
    y_ref = x @ w.T
    q_rtn = tb.rtn(_t(w), bits=3).dequantize().numpy()
    q_ada = tb.adaround(_t(w), _t(x), bits=3, iters=150).dequantize().numpy()
    assert np.mean((x @ q_ada.T - y_ref) ** 2) < \
        np.mean((x @ q_rtn.T - y_ref) ** 2)


# ---------------------------------------------------------------------------
# port vs reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_rtn_bit_identical_to_reference(rng, bits):
    """The default max scale: codes and scales bit-identical."""
    w = rng.normal(size=(24, 96)).astype(np.float32)
    w[:, 3] *= 12.0
    a = jb.rtn(jnp.asarray(w), bits)
    b = tb.rtn(_t(w), bits)
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    assert b.bits == a.bits and tuple(b.shape) == tuple(a.shape)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_rtn_mse_scale_bit_identical_to_reference(rng, bits):
    """The MSE scale (its default clip-ratio grid is the reference's
    ``jnp.linspace`` bit for bit): codes and scales bit-identical."""
    w = rng.normal(size=(24, 96)).astype(np.float32)
    w[:, 3] *= 12.0
    a = jb.rtn(jnp.asarray(w), bits, scale_method="mse")
    b = tb.rtn(_t(w), bits, scale_method="mse")
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    np.testing.assert_array_equal(b.codes().numpy(), np.asarray(a.codes()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equalize_pair_and_bias_correction_close_to_reference(seed):
    rng = np.random.default_rng(seed)
    w1 = rng.normal(size=(32, 16)).astype(np.float32)
    w1 *= np.logspace(-2, 1, 32)[:, None].astype(np.float32)
    w2 = rng.normal(size=(8, 32)).astype(np.float32)
    for a, b in zip(jb.equalize_pair(jnp.asarray(w1), jnp.asarray(w2)),
                    tb.equalize_pair(_t(w1), _t(w2))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    wq = np.asarray(jb.rtn(jnp.asarray(w2), 3).dequantize())
    mu = rng.normal(size=32).astype(np.float32)
    np.testing.assert_allclose(
        tb.bias_correction(_t(w2), _t(wq), _t(mu)).numpy(),
        np.asarray(jb.bias_correction(jnp.asarray(w2), jnp.asarray(wq),
                                      jnp.asarray(mu))), rtol=1e-6, atol=1e-6)


# (bits, M, N, iterations) -> share of codes equal to the reference's in
# the run that wrote this test
ADAROUND_CASES = {(3, 16, 64, 150): 1.0, (2, 8, 48, 100): 1.0,
                  (3, 64, 128, 300): 0.9946, (4, 32, 144, 200): 0.9848,
                  (4, 32, 144, 600): 0.9718}


@pytest.mark.parametrize("case", sorted(ADAROUND_CASES))
def test_adaround_close_to_reference(case):
    """The learned rounding follows float32 trajectories that differ from
    the reference's from the first step (libm's log and sigmoid differ from
    XLA's in the last bit on 14 % and 0.4 % of inputs; matmul sum orders
    differ), and the annealed regularizer commits borderline elements
    either way. Held: codes equal the reference's on at least 97 % of
    elements (measured 97.2-100 %, ``ADAROUND_CASES``), scales
    bit-identical, output MSE no worse than the reference's by more than
    1 %."""
    bits, m, n, iters = case
    rng = np.random.default_rng(bits + m)
    w = rng.normal(size=(m, n)).astype(np.float32)
    x = rng.normal(size=(128, n)).astype(np.float32)
    a = jb.adaround(jnp.asarray(w), jnp.asarray(x), bits=bits, iters=iters)
    b = tb.adaround(_t(w), _t(x), bits=bits, iters=iters)
    ca, cb = np.asarray(a.codes()), b.codes().numpy()
    assert (ca == cb).mean() >= 0.97
    np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
    y = x @ w.T
    ea = np.mean((x @ np.asarray(a.dequantize()).T - y) ** 2)
    eb = np.mean((x @ b.dequantize().numpy().T - y) ** 2)
    assert eb <= ea * 1.01


def test_synthesize_inputs_close_to_reference_stats():
    """Different generators, so different samples: both reach the target
    statistics within the reference's test bounds."""
    target = [0.5, 2.0]

    def stat_t(x):
        return torch.stack([torch.mean(x), torch.var(x, unbiased=False)])

    def stat_j(x):
        return jnp.stack([jnp.mean(x), jnp.var(x)])

    xj = jb.synthesize_inputs(stat_j, jnp.asarray(target), (16, 8),
                              jax.random.PRNGKey(1), iters=200)
    xt = tb.synthesize_inputs(stat_t, torch.tensor(target), (16, 8),
                              torch.Generator().manual_seed(1), iters=200)
    for s in (np.asarray(stat_j(xj)), stat_t(xt).numpy()):
        assert abs(s[0] - 0.5) < 0.05 and abs(s[1] - 2.0) < 0.1
