"""Port vs reference: the sliding-window ring cache of
``models/attention.py`` (``_cache_write``'s window branch,
``_ring_scatter``, the windowed ``_chunked_attention`` and
``causal_mask``, the ring's chunk continuation and its decode mask), fp and
int8. The same numpy inputs go through the reference function and the
port's: rings written from the same K/V must be bit-equal; through a whole
attention call (each package's own projections) float32 outputs and ring
rows agree within 1e-5, int8 codes within one step."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models.attention import init_attention as jax_init_attention
from repro.models.transformer import rope_values as jax_rope
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.models import attention as attn
from repro_torch.models.transformer import rope_values

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
B, KV, D, SLOTS = 2, 2, 16, 8
WINDOW = 8


def _kv(rng, s):
    return (rng.normal(size=(B, s, KV, D)).astype(np.float32),
            rng.normal(size=(B, s, KV, D)).astype(np.float32))


def _caches(rng, quant, stale=False):
    """A reference ring and its port copy; ``stale`` fills it with another
    admission's leftovers (random rows) instead of zeros."""
    jc = jattn.init_kv_cache(B, 40, KV, D, jnp.float32, quant, window=SLOTS)
    if stale:
        jc = {k: jnp.asarray(
            (rng.normal(size=v.shape) * 50).astype(np.asarray(v).dtype)
            if v.dtype != jnp.int8 else
            rng.integers(-127, 128, size=v.shape).astype(np.int8))
            for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}
    return jc, tc


def _equal(jc, tc):
    assert sorted(jc) == sorted(tc)
    for name in jc:
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]),
                                      err_msg=name)


def test_ring_init_has_min_of_max_len_and_window_slots():
    for max_len, window, slots in ((40, 8, 8), (6, 8, 6), (40, None, 40)):
        for quant in (False, True):
            c = attn.init_kv_cache(B, max_len, KV, D, torch.float32, quant,
                                   window=window, device="cpu")
            j = jattn.init_kv_cache(B, max_len, KV, D, jnp.float32, quant,
                                    window=window)
            assert {k: tuple(v.shape) for k, v in c.items()} == \
                {k: tuple(v.shape) for k, v in j.items()}
            assert c["k"].shape[1] == slots


# (s, pos): shorter than the ring at its start and mid-ring (a decode
# write past the ring's end lands at pos % slots), as wide as the ring,
# wider than it (rolled so token p sits at slot p % slots)
WRITES = {"s<slots prefill": (3, 0), "s<slots decode": (1, 13),
          "s<slots decode at wrap": (1, 16), "s==slots": (8, 0),
          "s==slots offset": (8, 5), "s>slots": (13, 0),
          "s>slots offset": (21, 3)}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", sorted(WRITES))
def test_cache_write_window_bit_equal(rng, case, quant):
    s, pos = WRITES[case]
    jc, tc = _caches(rng, quant, stale=True)
    k, v = _kv(rng, s)
    jc = jattn._cache_write(jc, jnp.asarray(k), jnp.asarray(v), pos, WINDOW)
    tc = attn._cache_write(tc, torch.from_numpy(k), torch.from_numpy(v), pos,
                           WINDOW)
    _equal(jc, tc)


def test_cache_write_raises_where_the_reference_would_clamp(rng):
    _, tc = _caches(rng, False)
    k, v = _kv(rng, 3)
    with pytest.raises(ValueError, match="exceeds the cache length"):
        attn._cache_write(tc, torch.from_numpy(k), torch.from_numpy(v), 6,
                          WINDOW)


# (s, pos): inside the ring, straddling its end, exactly the ring, wider
# than the ring (only the newest ``slots`` tokens are written), wider and
# straddling
SCATTERS = {"inside": (3, 2), "straddle": (5, 6), "ring": (8, 3),
            "wider": (13, 0), "wider straddle": (19, 11)}


@pytest.mark.parametrize("tensor_pos", [False, True], ids=["int", "0d"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("case", sorted(SCATTERS))
def test_ring_scatter_bit_equal(rng, case, quant, tensor_pos):
    s, pos = SCATTERS[case]
    jc, tc = _caches(rng, quant, stale=True)
    k, v = _kv(rng, s)
    jc = jattn._ring_scatter(jc, jnp.asarray(k), jnp.asarray(v),
                             jnp.int32(pos))
    tpos = torch.tensor(pos) if tensor_pos else pos
    tc = attn._ring_scatter(tc, torch.from_numpy(k), torch.from_numpy(v),
                            tpos)
    _equal(jc, tc)


@pytest.mark.parametrize("window", [None, 3, 8])
@pytest.mark.parametrize("row0", [0, 5])
def test_windowed_chunked_attention_matches(rng, window, row0):
    s, t, h = 6, 11, 4
    q = rng.normal(size=(B, s, h, D)).astype(np.float32)
    k, v = _kv(rng, t)
    want = jattn._chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=D ** -0.5,
        causal=True, window=window, row0=row0)
    got = attn._chunked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=D ** -0.5, causal=True, window=window, row0=row0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 1, 4])
@pytest.mark.parametrize("s,t", [(5, 5), (3, 9)])
def test_windowed_causal_mask_equal(s, t, window):
    np.testing.assert_array_equal(
        attn.causal_mask(s, t, window).numpy(),
        np.asarray(jattn.causal_mask(s, t, window)))


def _cfgs(window=WINDOW):
    over = dict(dtype="float32", window=window)
    return (dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                                **over),
            dataclasses.replace(get_config("granite-3-8b", reduced=True),
                                **over))


def _attn_params(jcfg):
    jp = jax_init_attention(jax.random.PRNGKey(0), jcfg)
    return jp, convert.from_jax_params(jax.device_get(jp), device="cpu")


_jax_attention = jax.jit(jattn.attention, static_argnames=("cfg", "mode"))


def _step(jcfg, tcfg, jp, tp, x, mode, jc, tc, pos):
    """One attention call of both packages at the absolute positions
    ``pos .. pos + s - 1``."""
    s = x.shape[1]
    positions = np.arange(pos, pos + s)
    jr = jax_rope(jnp.asarray(positions), jcfg.head_dim, jcfg.rope_theta)
    tr = rope_values(torch.from_numpy(positions), tcfg.head_dim,
                     tcfg.rope_theta)
    jo, jc = _jax_attention(jp, jnp.asarray(x), cfg=jcfg, rope=jr,
                            mode=mode, cache=jc, pos=jnp.int32(pos))
    to, tc = attn.attention(tp, torch.from_numpy(x), cfg=tcfg, rope=tr,
                            mode=mode, cache=tc, pos=pos)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close(jc, tc)
    return jc, tc, to


def _close(jc, tc):
    """Rings written from each package's own projections (whose sums may
    differ in the last bit): fp rows within 1e-5, int8 codes within one
    step and their scales within 1e-5."""
    assert sorted(jc) == sorted(tc)
    for name in jc:
        got, want = tc[name].numpy(), np.asarray(jc[name])
        if want.dtype == np.int8:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, err_msg=name, **TOL)


def _layer_caches(jcfg, rng, quant, stale):
    jc = jattn.init_kv_cache(B, 48, jcfg.n_kv_heads, jcfg.head_dim,
                             jnp.float32, quant, window=jcfg.window)
    if stale:
        jc = {k: jnp.asarray(
            (rng.normal(size=v.shape) * 50).astype(np.float32)
            if v.dtype != jnp.int8 else
            rng.integers(-127, 128, size=v.shape).astype(np.int8))
            for k, v in jc.items()}
    return jc, {k: torch.from_numpy(np.array(v)) for k, v in jc.items()}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_ring_chunks_over_stale_side_cache(rng, quant):
    """A chunked admission into a reused side cache whose ring holds another
    admission's rows, in chunks inside the ring (3, 3), straddling its end
    (5), wider than it (11) and after the wrap (2): every chunk's output and
    the ring match the reference, and the output is the one a zeroed ring
    gives (stale rows contribute exact zeros)."""
    chunks = (3, 3, 5, 11, 2)
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg)
    x = rng.normal(size=(B, sum(chunks), jcfg.d_model)).astype(np.float32)
    jc, tc = _layer_caches(jcfg, rng, quant, stale=True)
    _, clean = _layer_caches(jcfg, rng, quant, stale=False)
    pos = 0
    for n in chunks:
        xs = x[:, pos:pos + n]
        jc, tc, got = _step(jcfg, tcfg, jp, tp, xs, "chunk", jc, tc, pos)
        r = rope_values(torch.arange(pos, pos + n), tcfg.head_dim,
                        tcfg.rope_theta)
        want, clean = attn.attention(tp, torch.from_numpy(xs), cfg=tcfg,
                                     rope=r, mode="chunk", cache=clean,
                                     pos=pos)
        assert torch.equal(got, want)
        pos += n


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("prompt", [5, 8, 13])
def test_ring_decode_before_and_after_the_wrap(rng, prompt, quant):
    """Prefill (shorter, as wide as, or wider than the ring), then decode
    steps across the ring's end: at every step the outputs and the ring's
    fp rows within 1e-5 of the reference's, its int8 codes within one step
    (each package writes K/V from its own projections; the writes
    themselves are bit-equal above)."""
    jcfg, tcfg = _cfgs()
    jp, tp = _attn_params(jcfg)
    steps = 12
    x = rng.normal(size=(B, prompt + steps, jcfg.d_model)).astype(np.float32)
    jc, tc = _layer_caches(jcfg, rng, quant, stale=False)
    jc, tc, _ = _step(jcfg, tcfg, jp, tp, x[:, :prompt], "prefill", jc, tc,
                      0)
    for i in range(steps):
        p = prompt + i
        jc, tc, _ = _step(jcfg, tcfg, jp, tp, x[:, p:p + 1], "decode", jc,
                          tc, p)


def test_window_gates_name_themselves():
    _, tcfg = _cfgs()
    x = torch.zeros(2, 1, tcfg.d_model)
    with pytest.raises(NotImplementedError, match="'verify' mode is not "
                       "implemented for sliding-window ring-buffer caches"):
        attn.attention({}, x, cfg=tcfg, rope=None, mode="verify", cache={},
                       pos=torch.tensor([0, 0]))
    tp = attn.init_attention(torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    cache = attn.init_kv_cache(2, 16, tcfg.n_kv_heads, tcfg.head_dim,
                               torch.float32, window=tcfg.window,
                               device="cpu")
    pos = torch.tensor([1, 2])
    with pytest.raises(NotImplementedError, match="per-row decode positions"):
        attn.attention(tp, x, cfg=tcfg, rope=rope_values(
            pos[:, None], tcfg.head_dim, tcfg.rope_theta), mode="decode",
            cache=cache, pos=pos)
