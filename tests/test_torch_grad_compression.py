"""Port vs reference: ``training/grad_compression`` and the pod-compressed
train step.

* ``compress_local`` / ``unflatten_grads`` / ``ring_pad`` equal the
  reference's, bit for bit, in-process (the reference jitted, as its train
  step runs them: its block scale is ``amax * fl32(1/127)`` there).
* ``ring_allreduce_i8`` on 4 gloo ranks equals the reference's ring on 4
  host devices (``multidevice_run``), jitted as its train step runs it,
  bit for bit, on every rank. (Called eagerly, the reference's
  ``shard_map`` does not contract the hop's ``acc + codes * scale`` into a
  fused multiply-add and differs from its jitted self by one ulp on ~15%
  of the elements; the port mirrors the jitted form.)
* Pod-compressed training on 2 pods x 2 'data' ranks of the reference
  suite's tiny model keeps that suite's contract against the port's plain
  one-rank step (``tests/test_distributed.py::
  test_pod_compressed_training_learns``), with stable error-buffer shapes
  and identical parameters on every rank; the data-parallel step (no
  compression) on the same mesh tracks the plain step to float32 rounding.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.training import grad_compression as jgc
from repro_torch.distributed.group import run_local
from repro_torch.training import grad_compression as tgc


def _tree(rng, scale=1.0):
    shapes = {"b": [(37, 5), (3,)], "a": {"w": (70, 33), "g": (11,)},
              "c": (2, 2049)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return (rng.normal(size=s) * scale).astype(np.float32)
    return make(shapes)


def _map(fn, t):
    if isinstance(t, dict):
        return {k: _map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_map(fn, v) for v in t]
    return fn(t)


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


def test_compress_local_equals_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    grads = _tree(rng)
    err = _map(lambda a: a[None] * np.float32(1e-3), _tree(rng, 0.5))
    jflat, jerr = jax.jit(jgc.compress_local)(_map(jnp.asarray, grads),
                                              _map(jnp.asarray, err))
    tflat, terr = tgc.compress_local(_map(torch.from_numpy, grads),
                                     _map(torch.from_numpy, err))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    for a, b in zip(_leaves(terr), _leaves(jerr)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for n in (1, 2, 4):
        jp = np.asarray(jgc.ring_pad(jflat, n))
        tp = tgc.ring_pad(tflat, n)
        np.testing.assert_array_equal(tp.numpy(), jp)
        assert tp.shape[0] % (n * tgc.BLOCK) == 0
    jg = jgc.unflatten_grads(jflat, _map(jnp.asarray, grads))
    tg = tgc.unflatten_grads(tflat, _map(torch.from_numpy, grads))
    for a, b in zip(_leaves(tg), _leaves(jg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quant_block_equals_reference():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(64, tgc.BLOCK)) *
         rng.uniform(1e-6, 1e3, size=(64, 1))).astype(np.float32)
    x[3] = 0.0                                   # an all-zero block
    jc, js = jax.jit(jgc._quant_block)(jnp.asarray(x))
    tc, ts = tgc._quant_block(torch.from_numpy(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


_RING_CHILD = '''
import numpy as np, torch
import torch.distributed as dist
from repro_torch.training.grad_compression import ring_allreduce_i8

def main(xs):
    torch.set_num_threads(1)
    r = dist.get_rank()
    return ring_allreduce_i8(torch.from_numpy(xs[r]), None).numpy()
'''

_JAX_RING = """
import warnings; warnings.filterwarnings("ignore")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.distributed.compat import make_mesh, shard_map
from repro.training.grad_compression import ring_allreduce_i8
mesh = make_mesh((4,), ("pod",))
xs = np.load({path!r})
f = jax.jit(shard_map(lambda x: ring_allreduce_i8(x[0], "pod", 4)[None],
                      mesh, in_specs=P("pod"), out_specs=P("pod")))
np.save({out!r}, np.asarray(f(jnp.asarray(xs))))
print("DONE")
"""


def test_ring_allreduce_equals_reference_on_four_ranks(tmp_path,
                                                       multidevice_run):
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(4, 4 * tgc.BLOCK * 3)).astype(np.float32)
    xs[2, :tgc.BLOCK] *= 1e4                     # one loud block
    path, out = str(tmp_path / "xs.npy"), str(tmp_path / "jax.npy")
    np.save(path, xs)
    assert "DONE" in multidevice_run(
        textwrap.dedent(_JAX_RING.format(path=path, out=out)), devices=4)
    want = np.load(out)
    got = run_local(_RING_CHILD, 4, backend="gloo", device="cpu",
                    args=(xs,), timeout=120, store_dir=str(tmp_path))
    for r in range(4):
        np.testing.assert_array_equal(got[r], got[0])    # identical ranks
        np.testing.assert_array_equal(got[r], want[r])   # = the reference
    total = xs.sum(0)
    rel = np.abs(got[0] - total).max() / np.abs(total).max()
    assert rel < 0.03


_TRAIN_CHILD = '''
import dataclasses, hashlib
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.data.synthetic import markov_batches
from repro_torch.distributed.group import make_mesh
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import AdamWConfig, adamw_init, tree_leaves
from repro_torch.training.train_loop import init_pod_error, make_train_step

def _digest(tree):
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        h.update(t.detach().numpy().tobytes())
    return h.hexdigest()

def main(steps):
    torch.set_num_threads(1)
    cfg = get_config("granite-3-8b", reduced=True)
    cfg = dataclasses.replace(cfg, dtype="float32", n_layers=2,
                              d_model=32, n_heads=2, n_kv_heads=1,
                              head_dim=16, d_ff=64, vocab=64)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=0, decay_steps=100)
    mesh = make_mesh((2, 2), ("pod", "data"))
    plain = make_train_step(model, ocfg)
    comp = make_train_step(model, ocfg, pod_compress=True, mesh=mesh)
    dp = make_train_step(model, ocfg, mesh=mesh)
    it = markov_batches(8, 32, cfg.vocab, seed=1)
    clone = lambda t: {k: clone(v) for k, v in t.items()} \\
        if isinstance(t, dict) else [clone(v) for v in t] \\
        if isinstance(t, list) else t.clone()
    pp, po = params, adamw_init(params)
    cp, co = clone(params), adamw_init(params)
    dpp, dpo = clone(params), adamw_init(params)
    err = init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    pl, cl, dl = [], [], []
    for i in range(steps):
        b = {k: torch.from_numpy(np.ascontiguousarray(v))
             for k, v in next(it).items()}
        if dist.get_rank() == 0:        # the one-rank reference run
            pp, po, m1 = plain(pp, po, b)
            pl.append(float(m1["loss"]))
        cp, co, err, m2 = comp(cp, co, err, b)
        dpp, dpo, m3 = dp(dpp, dpo, b)
        cl.append(float(m2["loss"]))
        dl.append(float(m3["loss"]))
    assert [tuple(e.shape) for e in tree_leaves(err)] == shapes
    return pl, cl, dl, _digest(cp), _digest(dpp)
'''


def test_pod_compressed_training_learns_on_two_by_two(tmp_path):
    res = run_local(_TRAIN_CHILD, 4, backend="gloo", device="cpu",
                    args=(60,), timeout=300, store_dir=str(tmp_path))
    pl, cl, dl = (np.asarray(x) for x in res[0][:3])
    for r in res[1:]:                   # every rank holds the same numbers
        assert r[1] == res[0][1] and r[3] == res[0][3] and r[4] == res[0][4]
    plain0, plain1 = pl[:5].mean(), pl[-5:].mean()
    comp0, comp1 = cl[:5].mean(), cl[-5:].mean()
    assert plain1 < plain0 * 0.8
    assert comp1 < comp0 * 0.8                    # compression still learns
    assert abs(comp1 - plain1) < 0.25 * plain0    # and tracks plain DP
    # uncompressed data parallelism: the plain step's numbers up to the
    # order of the gradient sum
    np.testing.assert_allclose(dl, pl, rtol=2e-3, atol=0)
