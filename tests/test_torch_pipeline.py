"""Port vs reference: ``quantize_tree`` — the same numpy tree through both
packages, codes and scales compared leaf by leaf; batched == serial; one
device sync per tree; stack chunking; RTN."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.quant.qtypes import QuantizedTensor as JaxQT
from repro_torch.core import pipeline
from repro_torch.core.dispatch import BACKENDS, resolve_backend
from repro_torch.core.pipeline import METHODS, quantize_tree
from repro_torch.quant.qtypes import QuantizedTensor

from conftest import grid_weights

# small shapes: one thread a process, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _np_tree(rng, exact=False):
    """2-D dense (two sharing a grouped bucket), 3-D expert, 4-D conv,
    non-kernels. ``exact`` puts weights on a binary grid."""
    def w(*shape):
        if exact:
            return grid_weights(rng, int(np.prod(shape[:-1])),
                                shape[-1]).reshape(shape)
        return rng.normal(size=shape).astype(np.float32)
    return {
        "blk0": {"attn": {"w": w(256, 32)},
                 "norm": {"gain": np.ones((24,), np.float32)}},
        "blk1": {"attn": {"w": w(256, 32)}},          # same bucket as blk0
        "head": {"w": w(48, 16)},                     # whole-row bucket
        "moe": {"w": w(2, 16, 8)},                    # (E, in, out) expert
        "conv": {"w_conv": w(3, 3, 4, 8)},            # (KH, KW, in, out)
        "emb": {"table": w(10, 24)},                  # never quantized
    }


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    return fn(tree)


def _torch_tree(t):
    return _to(t, lambda a: torch.from_numpy(a.copy()))


def _qts(tree, path=()):
    """QuantizedTensor leaves in sorted-key order, with their paths."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _qts(tree[k], path + (k,))
        return out
    return [(path, tree)] if isinstance(tree, QuantizedTensor) else []


def _jax_qts(tree):
    leaves = jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, JaxQT))
    return [l for l in leaves if isinstance(l, JaxQT)]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("bits", [4, 8])
def test_tree_equals_reference_on_exact_inputs(rng, method, bits):
    src = _np_tree(rng, exact=True)
    tj, rj = jax_quantize_tree(_to(src, jnp.asarray), method=method,
                               bits=bits, group_size=128, backend="ref")
    tt, rt = quantize_tree(_torch_tree(src), method=method, bits=bits,
                           group_size=128, device="cpu")
    qa, qb = _jax_qts(tj), _qts(tt)
    assert len(qa) == len(qb) == 5
    for a, (path, b) in zip(qa, qb):
        assert tuple(a.shape) == b.shape, path
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        np.testing.assert_array_equal(b.codes().numpy(),
                                      np.asarray(a.codes()))
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
    assert [l.path for l in rt.layers] == [l.path for l in rj.layers]
    assert [b.key for b in rt.buckets] == [b.key for b in rj.buckets]
    if method != "rtn":
        assert any("g128" in b.key for b in rt.buckets)   # a grouped bucket


@pytest.mark.parametrize("method", ("rtn", "squant"))
def test_tree_close_to_reference_on_random_inputs(rng, method):
    """Random weights: scales bit-equal; codes equal except where a float32
    sum order tie moves a flip (counted; none on this seed)."""
    src = _np_tree(rng)
    tj, _ = jax_quantize_tree(_to(src, jnp.asarray), method=method, bits=4,
                              group_size=128, backend="ref")
    tt, _ = quantize_tree(_torch_tree(src), method=method, bits=4,
                          group_size=128, device="cpu")
    differing = 0
    for a, (_, b) in zip(_jax_qts(tj), _qts(tt)):
        np.testing.assert_array_equal(b.scale.numpy(), np.asarray(a.scale))
        diff = b.codes().numpy().astype(int) - np.asarray(a.codes()).astype(int)
        assert np.abs(diff).max() <= 1
        differing += int((diff != 0).any(axis=tuple(range(1, diff.ndim))).sum())
    assert differing <= 2, differing


@pytest.mark.parametrize("method", METHODS)
def test_batched_bit_exact_vs_serial(rng, method):
    src = _torch_tree(_np_tree(rng))
    t_b, rep_b = quantize_tree(src, method=method, bits=4, group_size=16,
                               batched=True, backend="ref", device="cpu")
    t_s, rep_s = quantize_tree(src, method=method, bits=4, group_size=16,
                               batched=False, device="cpu")
    qb, qs = _qts(t_b), _qts(t_s)
    assert len(qb) == len(qs) == 5
    for (_, a), (_, b) in zip(qb, qs):
        assert a.shape == b.shape
        assert torch.equal(a.codes(), b.codes())
        assert torch.equal(a.scale, b.scale)
    assert len(rep_b.layers) == len(rep_s.layers) == 5
    assert len(rep_b.buckets) == 4      # two same-shape layers share a bucket
    assert rep_b.total_millis > 0
    assert rep_b.backend == "ref" and rep_s.backend == "ref"


def test_fake_quant_restores_leaf_layout(rng):
    src = _np_tree(rng)
    tj, _ = jax_quantize_tree(_to(src, jnp.asarray), method="rtn", bits=4,
                              dequantize=True)
    tt, _ = quantize_tree(_torch_tree(src), method="rtn", bits=4,
                          dequantize=True, device="cpu")
    for key in ("blk0", "head", "moe", "conv"):
        sub_j, sub_t = tj[key], tt[key]
        while isinstance(sub_t, dict):
            k = next(k for k in sub_t if k in ("attn", "w", "w_conv"))
            sub_j, sub_t = sub_j[k], sub_t[k]
        assert tuple(sub_t.shape) == tuple(sub_j.shape)
        np.testing.assert_array_equal(sub_t.numpy(), np.asarray(sub_j))
    assert tt["emb"]["table"].shape == (10, 24)


def test_one_sync_per_tree_serial_one_per_leaf(rng, monkeypatch):
    calls = []
    real = pipeline._sync
    monkeypatch.setattr(pipeline, "_sync",
                        lambda d: (calls.append(1), real(d))[1])
    src = _torch_tree(_np_tree(rng))
    quantize_tree(src, bits=4, group_size=16, device="cpu")
    assert len(calls) == 1
    calls.clear()
    quantize_tree(src, bits=4, group_size=16, batched=False, device="cpu")
    assert len(calls) == 5


def test_stack_chunking_keeps_results(rng, monkeypatch):
    src = _torch_tree({f"l{i}": {"w": grid_weights(rng, 64, 32)}
                       for i in range(5)})
    whole, rep_w = quantize_tree(src, bits=4, group_size=16, device="cpu")
    monkeypatch.setattr(pipeline, "_MAX_STACK_BYTES", 2 * 64 * 32 * 4)
    parts, rep_p = quantize_tree(src, bits=4, group_size=16, device="cpu")
    assert len(rep_w.buckets) == 1 and len(rep_p.buckets) == 3   # 2 + 2 + 1
    for (_, a), (_, b) in zip(_qts(whole), _qts(parts)):
        assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)


def test_backend_and_method_validation(rng):
    assert BACKENDS == ("auto", "ref", "cuda")
    assert resolve_backend("auto", "cpu") == "ref"
    assert resolve_backend("auto", "cuda:0") == "cuda"
    with pytest.raises(ValueError):
        resolve_backend("pallas")
    with pytest.raises(ValueError):
        quantize_tree({}, method="nope", device="cpu")
    from repro_torch.distributed.sharding import AbstractMesh
    with pytest.raises(ValueError, match="no 'data' axis"):
        quantize_tree({}, mesh=AbstractMesh((2,), ("model",)), device="cpu")
    with pytest.raises(ValueError, match="batched=True"):
        quantize_tree({}, mesh=AbstractMesh((2,), ("data",)), device="cpu",
                      batched=False)
    with pytest.raises(ValueError):          # the kernel needs a CUDA tensor
        quantize_tree(_torch_tree({"a": {"w": grid_weights(rng, 64, 32)}}),
                      bits=4, group_size=16, backend="cuda", device="cpu")
