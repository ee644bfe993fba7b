"""Port vs reference: ``models/rwkv.py`` (RWKV-6 time mix and channel mix).

The same seeded numpy inputs and parameters go through the reference's
functions and the port's, in float32: ``wkv_scan`` and ``wkv_chunked``
(chunks 16 and 32) give outputs and final states within 1e-5, and the
time mix and channel mix agree within 1e-5 in train, prefill, chunk (a
continuation from a carried state) and decode, states included, with the
states' dtypes equal to the reference's by mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch import convert
from repro_torch.models import rwkv as trwkv

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 2, 3, 8


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _wkv_inputs(s, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, s, D)).astype(np.float32) * 0.5
               for _ in range(3))
    # log-decays inside the clamp the chunked form is exact for
    logw = -rng.uniform(1e-3, 2.0, (B, H, s, D)).astype(np.float32)
    u = rng.standard_normal((H, D)).astype(np.float32) * 0.1
    s0 = rng.standard_normal((B, H, D, D)).astype(np.float32) * 0.3
    return r, k, v, logw, u, s0


def _both(args):
    return ([jnp.asarray(a) for a in args],
            [torch.from_numpy(np.array(a)) for a in args])


@pytest.mark.parametrize("s", [1, 5, 32])
def test_wkv_scan_matches_reference(s):
    ja, ta = _both(_wkv_inputs(s))
    jo, js = jrwkv.wkv_scan(*ja)
    to, ts = trwkv.wkv_scan(*ta)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)


@pytest.mark.parametrize("chunk", [16, 32])
def test_wkv_chunked_matches_reference_and_scan(chunk):
    ja, ta = _both(_wkv_inputs(64, seed=1))
    jo, js = jrwkv.wkv_chunked(*ja, chunk=chunk)
    to, ts = trwkv.wkv_chunked(*ta, chunk=chunk)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    np.testing.assert_allclose(_np(ts), _np(js), **TOL)
    so, ss = trwkv.wkv_scan(*ta)
    np.testing.assert_allclose(_np(to), _np(so), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(ts), _np(ss), rtol=1e-4, atol=1e-4)


def _params(d=32, head_dim=8, d_ff=48):
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    jtm = jrwkv.init_rwkv_timemix(k1, d, head_dim, decay_lora=16)
    jcm = jrwkv.init_rwkv_channelmix(k2, d, d_ff)
    # mu away from 0.5 so that the streams differ, as after training
    rng = np.random.default_rng(7)
    for p in (jtm, jcm):
        p["mu"] = {s: jnp.asarray(rng.uniform(0, 1, d).astype(np.float32))
                   for s in p["mu"]}
    jtm["ln_x"]["gain"] = jnp.asarray(
        rng.uniform(0.5, 1.5, d).astype(np.float32))
    return (jtm, jcm, convert.from_jax_params(jax.device_get(jtm), "cpu"),
            convert.from_jax_params(jax.device_get(jcm), "cpu"))


def _x(s, d=32, seed=3, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _state_close(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype)
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL)


@pytest.mark.parametrize("mode,s", [("train", 32), ("train", 7),
                                    ("prefill", 32), ("prefill", 9)])
def test_timemix_and_channelmix_from_sequence_start(mode, s):
    """train and prefill (the chunked form where ``s`` divides by the
    chunk, the scan otherwise): outputs, and prefill's states."""
    jtm, jcm, ttm, tcm = _params()
    x = _x(s)
    jo, jst = jrwkv.rwkv_timemix(jtm, jnp.asarray(x), head_dim=8, mode=mode,
                                 chunk=16)
    to, tst = trwkv.rwkv_timemix(ttm, torch.from_numpy(x), head_dim=8,
                                 mode=mode, chunk=16)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    jco, jcs = jrwkv.rwkv_channelmix(jcm, jnp.asarray(x), mode=mode)
    tco, tcs = trwkv.rwkv_channelmix(tcm, torch.from_numpy(x), mode=mode)
    np.testing.assert_allclose(_np(tco), _np(jco), **TOL)
    if mode == "train":
        assert tst is None and tcs is None
    else:
        _state_close(tst, jst)
        _state_close(tcs, jcs)


@pytest.mark.parametrize("mode,s", [("chunk", 16), ("chunk", 5),
                                    ("decode", 1)])
def test_timemix_and_channelmix_continue_a_carried_state(mode, s):
    """chunk (a prefill continuation) and decode read the carried
    token-shift rows and wkv state; a prefill of 16 tokens makes it."""
    jtm, jcm, ttm, tcm = _params()
    x0, x1 = _x(16, seed=4), _x(s, seed=5)
    _, jst = jrwkv.rwkv_timemix(jtm, jnp.asarray(x0), head_dim=8,
                                mode="prefill", chunk=16)
    _, jcs = jrwkv.rwkv_channelmix(jcm, jnp.asarray(x0), mode="prefill")
    jstate = {**jst, **jcs}
    tstate = convert.from_jax_params(jax.device_get(jstate), "cpu")
    jo, jst2 = jrwkv.rwkv_timemix(jtm, jnp.asarray(x1), head_dim=8,
                                  state=jstate, mode=mode, chunk=16)
    to, tst2 = trwkv.rwkv_timemix(ttm, torch.from_numpy(x1), head_dim=8,
                                  state=tstate, mode=mode, chunk=16)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _state_close(tst2, jst2)
    jco, jcs2 = jrwkv.rwkv_channelmix(jcm, jnp.asarray(x1), state=jstate,
                                      mode=mode)
    tco, tcs2 = trwkv.rwkv_channelmix(tcm, torch.from_numpy(x1),
                                      state=tstate, mode=mode)
    np.testing.assert_allclose(_np(tco), _np(jco), **TOL)
    _state_close(tcs2, jcs2)


def test_prefill_ignores_a_stale_state_and_bf16_state_dtypes():
    """prefill starts a sequence whatever state it is handed; in bfloat16
    the token-shift rows come back in the activation dtype and the wkv
    state in float32, as in the reference."""
    jtm, _, ttm, _ = _params()
    x = _x(16)
    stale = {"x_tm": torch.ones((2, 32)), "wkv": torch.ones((2, 4, 8, 8))}
    a, _ = trwkv.rwkv_timemix(ttm, torch.from_numpy(x), head_dim=8,
                              mode="prefill", chunk=16)
    b, _ = trwkv.rwkv_timemix(ttm, torch.from_numpy(x), head_dim=8,
                              state=stale, mode="prefill", chunk=16)
    assert torch.equal(a, b)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    _, st = trwkv.rwkv_timemix(ttm, xb, head_dim=8, mode="prefill", chunk=16)
    _, jst = jrwkv.rwkv_timemix(jtm, jnp.asarray(x, jnp.bfloat16),
                                head_dim=8, mode="prefill", chunk=16)
    assert st["x_tm"].dtype == torch.bfloat16 == getattr(
        torch, str(jst["x_tm"].dtype))
    assert st["wkv"].dtype == torch.float32 == getattr(
        torch, str(jst["wkv"].dtype))


def test_init_shapes_and_keys_match_reference():
    """The port's init makes the reference's tree: the same keys, shapes
    and dtypes (the decay stream's lerp keyed "d", so the quantizer skips
    it), and the reference's constants."""
    jtm = jrwkv.init_rwkv_timemix(jax.random.PRNGKey(0), 64, 16)
    ttm = trwkv.init_rwkv_timemix(torch.Generator().manual_seed(0), 64, 16)
    jt = convert.from_jax_params(jax.device_get(jtm), "cpu")

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), v.dtype) for k, v in t.items()}
    assert shapes(ttm) == shapes(jt)
    assert sorted(ttm["mu"]) == ["d", "g", "k", "r", "v"]
    assert np.array_equal(np.asarray(jtm["w0"]), _np(ttm["w0"]))
    assert np.array_equal(np.asarray(jtm["ln_x"]["gain"]),
                          _np(ttm["ln_x"]["gain"]))
    for s in ttm["mu"]:
        assert np.array_equal(np.asarray(jtm["mu"][s]), _np(ttm["mu"][s]))
    assert float(ttm["w_lora_b"]["w"].std()) < 0.05
