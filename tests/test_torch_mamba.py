"""Port vs reference: ``models/mamba.py`` (the S6 selective SSM of Jamba).

The same seeded numpy inputs and the reference's parameters go through
the reference's functions and the port's, in float32, within 1e-5:
``_chunk_scan`` (the Hillis-Steele doubling against
``lax.associative_scan``), and ``mamba`` in train and prefill (the
whole-sequence branch, and the loop over chunks, at the real 512-token
chunk too), chunk (a continuation from a carried state) and decode. The
state dtypes equal the reference's by mode, in float32 and bfloat16. A
quantized tree serves through ``dt_rank`` given by the stack."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro_torch import convert
from repro_torch.core.pipeline import quantize_tree
from repro_torch.models import mamba as tmamba

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
D, N, DT_RANK = 16, 4, 4


def _np(t):
    return t.detach().to(torch.float32).numpy() \
        if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _params():
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), D, d_state=N,
                           dt_rank=DT_RANK)
    return jp, convert.from_jax_params(jax.device_get(jp), "cpu")


def _x(s, seed=3, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, D)).astype(np.float32)


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


def _state_close(got, want, tol=TOL):
    assert sorted(got) == sorted(want)
    for k in want:
        assert _dtype_name(got[k]) == str(want[k].dtype), k
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **tol)


@pytest.mark.parametrize("c", [1, 7, 64])
def test_chunk_scan_matches_reference(c):
    rng = np.random.default_rng(c)
    a = rng.uniform(0.5, 1.0, (2, c, 8, N)).astype(np.float32)
    bx = rng.standard_normal((2, c, 8, N)).astype(np.float32)
    h0 = rng.standard_normal((2, 8, N)).astype(np.float32)
    jh, jl = jmamba._chunk_scan(jnp.asarray(a), jnp.asarray(bx),
                                jnp.asarray(h0))
    th, tl = tmamba._chunk_scan(torch.from_numpy(a), torch.from_numpy(bx),
                                torch.from_numpy(h0))
    np.testing.assert_allclose(_np(th), _np(jh), **TOL)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("s,chunk", [(24, 512), (32, 8), (1024, 512)],
                         ids=["whole_sequence", "chunk_loop",
                              "chunk_loop_512"])
def test_mamba_from_sequence_start(mode, s, chunk):
    """train/prefill: the whole-sequence branch (``s <= chunk``) and the
    loop over chunks (``s > chunk``, ``s % chunk == 0``); prefill's state
    (float32 ``h``, the conv tail in the activation dtype)."""
    jp, tp = _params()
    x = _x(s, b=1 if s > 100 else 2)
    jo, jst = jmamba.mamba(jp, jnp.asarray(x), d_state=N, mode=mode,
                           chunk=chunk)
    to, tst = tmamba.mamba(tp, torch.from_numpy(x), d_state=N, mode=mode,
                           chunk=chunk)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    if mode == "train":
        assert tst is None and jst is None
    else:
        _state_close(tst, jst)


def _carried(jp, tp, dtype):
    """A prefill of 12 tokens in ``dtype``, then its state as the
    contiguous pool holds it (float32, ``admit_rows`` casts)."""
    x0 = _x(12, seed=4)
    _, jst = jmamba.mamba(jp, jnp.asarray(x0, dtype), d_state=N,
                          mode="prefill")
    jst = {k: v.astype(jnp.float32) for k, v in jst.items()}
    return jst, convert.from_jax_params(jax.device_get(jst), "cpu")


@pytest.mark.parametrize("mode,s", [("chunk", 8), ("chunk", 5),
                                    ("decode", 1)])
def test_mamba_continues_a_carried_state(mode, s):
    jp, tp = _params()
    jst, tst = _carried(jp, tp, jnp.float32)
    x1 = _x(s, seed=5)
    jo, jst2 = jmamba.mamba(jp, jnp.asarray(x1), d_state=N, state=jst,
                            mode=mode)
    to, tst2 = tmamba.mamba(tp, torch.from_numpy(x1), d_state=N, state=tst,
                            mode=mode)
    np.testing.assert_allclose(_np(to), _np(jo), **TOL)
    _state_close(tst2, jst2)


def test_state_dtypes_by_mode_in_bfloat16():
    """bfloat16 activations: prefill's conv tail is bfloat16, chunk's
    float32; decode keeps the dtype the reference's concatenate promotes
    to (float32 from the pool's tail, bfloat16 from a prefill's, the round
    scheduler's cache); ``h`` is always float32."""
    jp, tp = _params()
    x = _x(12)
    xb, jxb = torch.from_numpy(x).to(torch.bfloat16), \
        jnp.asarray(x, jnp.bfloat16)
    _, jpre = jmamba.mamba(jp, jxb, d_state=N, mode="prefill")
    _, tpre = tmamba.mamba(tp, xb, d_state=N, mode="prefill")
    bf = dict(rtol=2e-2, atol=2e-2)
    _state_close(tpre, jpre, bf)
    one = _x(1, seed=6)
    tone, jone = torch.from_numpy(one).to(torch.bfloat16), \
        jnp.asarray(one, jnp.bfloat16)
    # decode straight after a prefill (the round scheduler)
    _, jd = jmamba.mamba(jp, jone, d_state=N, state=jpre, mode="decode")
    _, td = tmamba.mamba(tp, tone, d_state=N, state=tpre, mode="decode")
    _state_close(td, jd, bf)
    # chunk and decode from the pool's float32 state
    j32 = {k: v.astype(jnp.float32) for k, v in jpre.items()}
    t32 = {k: v.to(torch.float32) for k, v in tpre.items()}
    for mode, (jx, tx) in (("chunk", (jxb, xb)), ("decode", (jone, tone))):
        _, js = jmamba.mamba(jp, jx, d_state=N, state=j32, mode=mode)
        _, ts = tmamba.mamba(tp, tx, d_state=N, state=t32, mode=mode)
        _state_close(ts, js, bf)


def test_init_matches_reference_shapes_and_constants():
    jp, tp = _params()
    own = tmamba.init_mamba(torch.Generator().manual_seed(0), D, d_state=N,
                            dt_rank=DT_RANK)

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), v.dtype) for k, v in t.items()}
    assert shapes(own) == shapes(tp)
    for k in ("a_log", "d_skip", "conv_b"):
        assert torch.equal(own[k], tp[k])
    dt = torch.nn.functional.softplus(own["dt_bias"])
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    st = tmamba.init_mamba_state(3, D, N)
    js = jmamba.init_mamba_state(3, D, N)
    assert {k: (tuple(v.shape), _dtype_name(v)) for k, v in st.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in js.items()}


def test_quantized_tree_serves_with_the_stacks_dt_rank():
    """A quantized kernel stores (out, in), so ``dt_proj``'s shape no longer
    gives ``dt_rank`` (the reference reads it there and cannot run a
    real-quantized mamba); with ``dt_rank`` from the stack the quantized
    mixer equals the dense mixer on the dequantized weights."""
    _, tp = _params()
    q, _ = quantize_tree(tp, method="squant", bits=8, device="cpu")
    dq, _ = quantize_tree(tp, method="squant", bits=8, dequantize=True,
                          device="cpu")
    x = torch.from_numpy(_x(9))
    for mode in ("train", "prefill"):
        a, _ = tmamba.mamba(q, x, d_state=N, mode=mode, dt_rank=DT_RANK)
        b, _ = tmamba.mamba(dq, x, d_state=N, mode=mode)
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
    with pytest.raises(RuntimeError):
        tmamba.mamba(q, x, d_state=N, mode="train")
