"""Port vs reference: ``core/hessian`` (Algorithm 3, the objectives of Eqs.
(4), (6) and (8), and the approximation-precision analysis of Appendix A.3).

The reference's own cases (``tests/test_hessian.py``) run on the port; the
decomposition, reconstruction and objectives agree with the reference's
within 1e-10 (float64); ``APReport``'s counts are equal on the same layer
and activations; the port's flip recorder gives ``squant_codes``' codes."""
import numpy as np
import pytest
import torch

from repro.core import hessian as jh
from repro_torch.core import hessian as th
from repro_torch.core.squant import squant_codes
from repro_torch.quant.scales import max_scale
from test_hessian import _correlated_inputs

TOL = 1e-10


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

def test_decomposition_positive_and_psd(rng):
    x = _correlated_inputs(rng, 2000, 8, 9)
    h = th.second_moment(_t(x))
    co = th.decompose(h, group_size=9)
    assert co.c > 0
    assert bool(torch.all(co.k > 0)) and bool(torch.all(co.e > 0))
    rec = th.reconstruction(co)
    np.testing.assert_allclose(torch.diagonal(rec).numpy(),
                               torch.diagonal(h).abs().numpy(), rtol=1e-10)
    assert float(torch.linalg.eigvalsh(rec).min()) > -1e-8


def test_objectives_agree_on_structured_h(rng):
    x = _correlated_inputs(rng, 500, 4, 8)
    co = th.decompose(th.second_moment(_t(x)), group_size=8)
    rec = th.reconstruction(co)
    d = _t(rng.normal(size=32))
    np.testing.assert_allclose(th.precise_objective(d, co),
                               th.exact_objective(d, rec), rtol=1e-9)


def test_approx_objective_is_unit_coeff_case(rng):
    d = rng.normal(size=24)
    got = th.approx_objective(_t(d), group_size=8)
    dg = d.reshape(3, 8)
    want = (d ** 2).sum() + (dg.sum(1) ** 2).sum() + d.sum() ** 2
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("bits", [3, 4])
def test_approximation_precision_high(rng, bits):
    n, k = 16, 9
    x = _correlated_inputs(rng, 4000, n, k)
    w = rng.normal(size=(32, n * k)).astype(np.float32) * 0.2
    rep = th.approximation_precision(_t(w), _t(x), bits=bits, group_size=k)
    assert rep.flipped > 100
    assert rep.ap > 0.9, f"AP too low: {rep.ap:.3f} ({rep.by_stage})"
    assert rep.ap_exact > 0.9, f"exact-H AP too low: {rep.ap_exact:.3f}"
    assert rep.ap_inorder > 0.5


def test_ap_uses_no_weight_gradients(rng):
    n, k = 8, 4
    w = rng.normal(size=(8, n * k)).astype(np.float32)
    x1 = _correlated_inputs(rng, 256, n, k)
    x2 = _correlated_inputs(np.random.default_rng(7), 256, n, k)
    r1 = th.approximation_precision(_t(w), _t(x1), bits=4, group_size=k)
    r2 = th.approximation_precision(_t(w), _t(x2), bits=4, group_size=k)
    assert r1.flipped == r2.flipped


# ---------------------------------------------------------------------------
# port vs reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,samples", [(8, 9, 2000), (4, 8, 500),
                                         (16, 4, 300)])
def test_decompose_and_reconstruction_equal_reference(n, k, samples):
    """second_moment, decompose and reconstruction within 1e-10 of the
    reference (float64)."""
    x = _correlated_inputs(np.random.default_rng(n * k), samples, n, k)
    hj, ht = jh.second_moment(x), th.second_moment(_t(x))
    np.testing.assert_allclose(ht.numpy(), hj, rtol=0, atol=TOL)
    cj, ct = jh.decompose(hj, k), th.decompose(ht, k)
    assert abs(ct.c - cj.c) <= TOL and ct.group_size == cj.group_size == k
    np.testing.assert_allclose(ct.k.numpy(), cj.k, rtol=0, atol=TOL)
    np.testing.assert_allclose(ct.e.numpy(), cj.e, rtol=0, atol=TOL)
    np.testing.assert_allclose(th.reconstruction(ct).numpy(),
                               jh.reconstruction(cj), rtol=0, atol=TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_objectives_equal_reference(seed):
    """Eqs. (4), (6) and (8) on the same δ and H within 1e-10."""
    rng = np.random.default_rng(seed)
    x = _correlated_inputs(rng, 400, 6, 8)
    h = jh.second_moment(x)
    cj, ct = jh.decompose(h, 8), th.decompose(_t(h), 8)
    d = rng.normal(size=48) * 0.4
    assert abs(th.precise_objective(_t(d), ct)
               - jh.precise_objective(d, cj)) <= TOL
    assert abs(th.exact_objective(_t(d), _t(h))
               - jh.exact_objective(d, h)) <= TOL
    assert abs(th.approx_objective(_t(d), 8)
               - jh.approx_objective(d, 8)) <= TOL


def test_decompose_refuses_ragged_groups():
    with pytest.raises(ValueError):
        th.decompose(torch.eye(10, dtype=torch.float64), 4)


@pytest.mark.parametrize("bits,enable_c,m,n,k", [
    (3, True, 32, 16, 9), (4, True, 32, 16, 9), (4, False, 32, 16, 9),
    (4, True, 8, 8, 4), (8, True, 16, 6, 16)])
def test_ap_report_equals_reference(bits, enable_c, m, n, k):
    """APReport's flipped / correct / correct_exact / correct_inorder /
    by_stage equal the reference's on the same layer and activations."""
    rng = np.random.default_rng(bits * 100 + m + n + k)
    x = _correlated_inputs(rng, 1000, n, k)
    w = rng.normal(size=(m, n * k)).astype(np.float32) * 0.2
    a = jh.approximation_precision(w, x, bits=bits, group_size=k,
                                   enable_c=enable_c)
    b = th.approximation_precision(_t(w), _t(x), bits=bits, group_size=k,
                                   enable_c=enable_c)
    assert (b.flipped, b.correct, b.correct_exact, b.correct_inorder) == \
        (a.flipped, a.correct, a.correct_exact, a.correct_inorder)
    assert b.by_stage == a.by_stage
    assert (b.ap, b.ap_exact, b.ap_inorder) == (a.ap, a.ap_exact,
                                                a.ap_inorder)


@pytest.mark.parametrize("bits", [3, 4, 8])
@pytest.mark.parametrize("enable_c", [True, False])
def test_recorder_codes_equal_squant_codes(rng, bits, enable_c):
    """The sequential flip recorder (the in-order diagnostic's log) lands on
    ``squant_codes``' codes, and its δ is codes − w/s."""
    w = torch.from_numpy(rng.normal(size=(24, 96)).astype(np.float32))
    s = max_scale(w, bits)
    codes, _, _ = squant_codes(w, s, bits=bits, group_size=8, enable_k=True,
                               enable_c=enable_c)
    ws = w.double() / s.double()
    rc, rd, log = th._record_flips(ws.numpy(), bits, 8, enable_c)
    np.testing.assert_array_equal(rc, codes.numpy())
    np.testing.assert_allclose(rd, codes.double().numpy() - ws.numpy(),
                               rtol=0, atol=1e-12)
    assert {ev.stage for ev in log} <= {"K", "C"}
    if not enable_c:
        assert all(ev.stage == "K" for ev in log)
