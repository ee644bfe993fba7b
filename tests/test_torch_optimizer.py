"""Port vs reference: ``training/optimizer`` (AdamW). The same params,
grads and state (seeded numpy) go through both packages' ``adamw_update``
for several steps: inside warmup, after it and past the decay, with the
global-norm clip on and off, a bfloat16 leaf and 1-D leaves (no weight
decay). Params, ``m`` and ``v`` agree within ``rtol=1e-6, atol=1e-7``
(float32); ``lr`` and ``grad_norm`` within ``rtol=1e-6``. JAX flattens the
tree in sorted-key order and the port sums the norm in the same order, but
XLA's CPU arithmetic (``pow``, ``cos``) may differ in the last bit: a
tolerance, not bit equality."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.training import optimizer as jopt
from repro_torch import convert
from repro_torch.training import optimizer as topt

torch.set_num_threads(1)
TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(rng, bf16=False):
    t = {"stack": {"list": [{"w": rng.normal(size=(6, 5)).astype(np.float32),
                             "gain": rng.normal(size=(5,)).astype(np.float32)}
                            for _ in range(2)]},
         "emb": {"embedding": rng.normal(size=(7, 5)).astype(np.float32)},
         "bias": rng.normal(size=(3,)).astype(np.float32)}
    if bf16:
        t["emb"]["embedding"] = t["emb"]["embedding"].astype(
            ml_dtypes.bfloat16)
    return t


def _np(tree):
    """A torch tree as numpy (bfloat16 as float32)."""
    return topt.tree_map(lambda t: t.float().numpy(), tree)


def _close(a, b, **tol):
    la = jax.tree_util.tree_leaves(a)
    lb = topt.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if torch.is_tensor(y):
            y = y.float().numpy()
        np.testing.assert_allclose(np.asarray(y, np.float32),
                                   np.asarray(x, np.float32), **tol)


CFGS = {
    "clip": jopt.AdamWConfig(lr=1e-2, warmup_steps=3, decay_steps=8,
                             clip_norm=0.5),
    "noclip": jopt.AdamWConfig(lr=1e-2, warmup_steps=3, decay_steps=8,
                               clip_norm=None, weight_decay=0.05),
    "nowarmup": jopt.AdamWConfig(lr=3e-3, warmup_steps=0, decay_steps=5,
                                 clip_norm=1.0),
}


@pytest.mark.parametrize("name", sorted(CFGS))
@pytest.mark.parametrize("bf16", [False, True])
def test_adamw_update_matches_reference(name, bf16):
    """12 steps: inside warmup, after it, and past ``decay_steps``."""
    jcfg = CFGS[name]
    tcfg = topt.AdamWConfig(**jcfg.__dict__)
    rng = np.random.default_rng(0)
    p = _tree(rng, bf16)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = convert.from_jax_params(p, device="cpu")
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    for step in range(12):
        g = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), p)
        if bf16:
            g["emb"]["embedding"] = g["emb"]["embedding"].astype(
                ml_dtypes.bfloat16)
        jp, js, jinfo = jopt.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        tp, ts, tinfo = topt.adamw_update(
            tp, convert.from_jax_params(g, device="cpu"), ts, tcfg)
        np.testing.assert_allclose(float(tinfo["lr"]), float(jinfo["lr"]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(tinfo["grad_norm"]),
                                   float(jinfo["grad_norm"]), rtol=1e-6,
                                   atol=0)
        _close(jp, tp, **TOL)
        _close(js["m"], ts["m"], **TOL)
        _close(js["v"], ts["v"], **TOL)
        assert int(ts["step"]) == int(js["step"]) == step + 1
    if bf16:
        assert tp["emb"]["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 1, 2, 3, 5, 7, 8, 20])
def test_schedule_matches_reference(step):
    jcfg = jopt.AdamWConfig(lr=1e-2, warmup_steps=3, decay_steps=8,
                            min_lr_ratio=0.2)
    a = float(jopt._schedule(jcfg, jnp.asarray(step, jnp.int32)))
    b = topt._schedule(topt.AdamWConfig(**jcfg.__dict__),
                       torch.tensor(step, dtype=torch.int32))
    assert b.dtype == torch.float32 and b.ndim == 0
    np.testing.assert_allclose(float(b), a, rtol=1e-6, atol=0)


def test_no_weight_decay_on_1d_leaves():
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5,
                           clip_norm=None)
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    g = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    newp, _, _ = topt.adamw_update(p, g, topt.adamw_init(p), cfg)
    torch.testing.assert_close(newp["b"], p["b"], rtol=0, atol=0)
    assert torch.all(newp["w"] < 1.0)


def test_decay_mask_follows_the_stacked_reference():
    """The reference's stacked ``periods`` layout (``scan_layers``) decays
    its (periods, d) gains. The port's unrolled tree decays them too under
    ``decay_mask(stacked=True)``, and agrees with the reference over four
    steps; under the default mask its 1-D gains are not decayed."""
    jcfg = CFGS["clip"]
    tcfg = topt.AdamWConfig(**jcfg.__dict__)
    rng = np.random.default_rng(1)
    p = _tree(rng)
    layers = p["stack"]["list"]
    p["stack"] = {"periods": {k: np.stack([lay[k] for lay in layers])
                              for k in ("w", "gain")}}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = convert.from_jax_params(p, device="cpu")
    mask = topt.decay_mask(tp, stacked=True)
    assert [lay["gain"] for lay in mask["stack"]["list"]] == [True, True]
    assert not mask["bias"] and mask["emb"]["embedding"]
    assert not any(lay["gain"] for lay in topt.decay_mask(tp)["stack"]["list"])
    js, ts, us = jopt.adamw_init(jp), topt.adamw_init(tp), topt.adamw_init(tp)
    up = tp
    for _ in range(4):
        g = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * 3).astype(np.float32), p)
        jp, js, _ = jopt.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        tg = convert.from_jax_params(g, device="cpu")
        tp, ts, _ = topt.adamw_update(tp, tg, ts, tcfg, mask)
        up, us, _ = topt.adamw_update(up, tg, us, tcfg)
    want = convert.from_jax_params(jax.device_get(jp), device="cpu")
    for a, b in zip(topt.tree_leaves(want), topt.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)
    gain = want["stack"]["list"][0]["gain"].numpy()
    assert not np.allclose(up["stack"]["list"][0]["gain"].numpy(), gain,
                           **TOL)


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor([2.0])}
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, decay_steps=100,
                           weight_decay=0.0, clip_norm=None)
    state = topt.adamw_init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    l0 = float(loss(params))
    for _ in range(50):
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        gw, gb = torch.autograd.grad(loss(live), [live["w"], live["b"]])
        params, state, _ = topt.adamw_update(params, {"w": gw, "b": gb},
                                             state, cfg)
    assert float(loss(params)) < l0 * 0.1


def test_adamw_leaves_its_inputs_unchanged():
    rng = np.random.default_rng(1)
    p = convert.from_jax_params(_tree(rng), device="cpu")
    g = topt.tree_map(lambda t: torch.ones_like(t), p)
    s = topt.adamw_init(p)
    before = _np(p)
    topt.adamw_update(p, g, s, topt.AdamWConfig(warmup_steps=0))
    _close(before, p, rtol=0, atol=0)
    assert int(s["step"]) == 0 and float(topt.global_norm(s["m"])) == 0.0
