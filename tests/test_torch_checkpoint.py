"""Port vs reference: ``checkpoint/checkpointer``.

The reference's own cases (``tests/test_checkpoint_quantized.py``, apart
from resharding) on the port, then checkpoints crossing between the two
packages in both directions, written by the test itself: the reference
writes (fp and quantized, stacked and unrolled, a bfloat16 leaf) and the
port reads, bit for bit; the port writes and the reference's
``restore_serving`` and ``_restore_raw`` read, bit for bit. The same tree
gives the same ``index.json`` and the same npz members, byte for byte. The
reference cannot restore a bfloat16 leaf from its own checkpoint (a
``TypeError`` in ``jnp.asarray``); that is recorded as its behaviour. A
restore onto the card is in ``tests/test_torch_reload_cuda.py``.
"""
import dataclasses
import json
import os
import struct
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.quant import apply as japply
from repro_torch import convert
from repro_torch.checkpoint import CheckpointMetaError, Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.pipeline import quantize_tree
from repro_torch.models.model import build_model
from repro_torch.quant.apply import (is_quantized_tree, quant_tree_meta,
                                     quantize_params_serving)
from repro_torch.quant.qtypes import QuantizedTensor

torch.set_num_threads(1)

_TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)


def _tiny(seed=0):
    """The port's tiny model and its own random tree (unrolled)."""
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **_TINY)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(seed),
                             device="cpu"), cfg


def _jax_tiny(seed=0, scan=True, dtype="float32"):
    cfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                              scan_layers=scan, **dict(_TINY, dtype=dtype))
    return jax_build_model(cfg).init(jax.random.PRNGKey(seed))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    if isinstance(tree, QuantizedTensor):
        return {"/".join(path + ("0",)): tree.data,
                "/".join(path + ("1",)): tree.scale}
    return {"/".join(path): tree}


def _bits(x) -> np.ndarray:
    """Any leaf's values as raw bits (bfloat16 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" or \
        a.dtype.kind == "V" else a


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _assert_trees_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert _dtype_name(fa[k]) == _dtype_name(fb[k]), k
        np.testing.assert_array_equal(_bits(fa[k]), _bits(fb[k]), err_msg=k)


# ---------------------------------------------------------------------------
# the reference's cases, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_roundtrip_bit_exact(tmp_path, bits):
    model, params, _ = _tiny()
    qtree, meta = quantize_params_serving(params, bits, "squant")
    assert is_quantized_tree(qtree) and not is_quantized_tree(params)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(3, qtree, quant_meta=meta)
    restored, m, step = ck.restore_serving(
        expect={"quantize_weights": "squant", "weight_bits": bits},
        device="cpu")
    assert step == 3 and m["format"] == "quantized"
    assert m["quant"]["bits"] == bits and m["quant"]["method"] == "squant"
    assert m["quant"]["packed_int4"] == (bits <= 4)
    _assert_trees_equal(qtree, restored)
    assert set(ck.timings) == {"read_ms", "h2d_ms"}


def test_int4_nibbles_stay_packed_on_disk(tmp_path):
    model, params, _ = _tiny()
    qtree, meta = quantize_params_serving(params, 4, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    data = np.load(str(tmp_path / "step_00000001" / "shard_00000.npz"))
    q4_keys = [k for k in data.files if k.endswith("w_q4")]
    assert q4_keys, "no packed int4 payload on disk"
    for k in q4_keys:
        assert data[k].dtype == np.int8            # two nibbles per byte
        scale = data[k.replace("w_q4", "w_scale")]
        assert data[k].shape[-2] == scale.shape[-2]


def test_restore_rejects_bits_and_method_mismatch(tmp_path):
    model, params, _ = _tiny()
    qtree, meta = quantize_params_serving(params, 4, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    for expect, msg in (({"quantize_weights": "squant", "weight_bits": 8},
                         "mismatch"),
                        ({"quantize_weights": "rtn", "weight_bits": 4},
                         "mismatch"),
                        ({"quantize_weights": None, "weight_bits": 8},
                         "unquantized")):
        with pytest.raises(CheckpointMetaError, match=msg):
            ck.restore_serving(expect=expect, device="cpu")
    ck.restore_serving(expect={"quantize_weights": "squant",
                               "weight_bits": 4}, device="cpu")
    ck.restore_serving(device="cpu")


def test_training_restore_rejects_quantized_checkpoint(tmp_path):
    model, params, _ = _tiny()
    qtree, meta = quantize_params_serving(params, 8, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    with pytest.raises(CheckpointMetaError, match="restore_serving"):
        ck.restore(1, template=(params, {}), device="cpu")


def test_save_serving_requires_bits_and_method(tmp_path):
    model, params, _ = _tiny()
    qtree, _ = quantize_params_serving(params, 8, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    with pytest.raises(ValueError, match="quant_meta missing"):
        ck.save_serving(1, qtree, quant_meta={"bits": 8})


@pytest.mark.parametrize("kind", ["fp", "quantized"])
def test_restore_skips_torn_and_corrupt_steps(tmp_path, kind):
    model, params, _ = _tiny(0)
    _, params2, _ = _tiny(1)
    ck = Checkpointer(str(tmp_path), async_save=False)

    def save(step, tree):
        if kind == "fp":
            ck.save_serving(step, tree)
        else:
            q, m = quantize_params_serving(tree, 8, "squant")
            ck.save_serving(step, q, quant_meta=m)

    save(1, params)
    save(2, params2)
    save(3, params2)
    os.remove(str(tmp_path / "step_00000002" / "COMMITTED"))     # torn
    with open(str(tmp_path / "step_00000003" / "index.json"), "w") as f:
        f.write('{"trees": ')                                    # corrupt
    assert ck.list_steps() == [1]
    _, meta, step = ck.restore_serving(device="cpu")
    assert step == 1
    with pytest.raises(CheckpointMetaError, match="COMMITTED"):
        ck.read_meta(2)
    with pytest.raises(CheckpointMetaError, match="index.json"):
        ck.read_meta(3)


def test_gc_removes_invalid_step_dirs(tmp_path):
    model, params, _ = _tiny()
    ck = Checkpointer(str(tmp_path), async_save=False, keep=2)
    ck.save_serving(1, params)
    ck.save_serving(2, params)
    os.remove(str(tmp_path / "step_00000001" / "COMMITTED"))     # now torn
    ck.save_serving(3, params)                                   # runs _gc
    assert not (tmp_path / "step_00000001").exists()
    assert ck.list_steps() == [2, 3]


def test_quant_tree_meta_report_digest():
    model, params, _ = _tiny()
    _, report = quantize_tree(params, method="squant", bits=8,
                              dequantize=True, device="cpu")
    meta = quant_tree_meta(8, "squant", 128, report=report)
    assert meta["report"]["layers"] == len(report.layers)
    assert meta["report"]["backend"] == report.backend
    json.dumps(meta)                                 # index.json-safe


def test_training_state_roundtrip_async(tmp_path):
    """``save`` of params + an optimizer tree with a scalar, None and a
    QuantizedTensor, written on a thread; ``restore`` by template and
    ``restore_latest`` without one."""
    model, params, _ = _tiny()
    qt = QuantizedTensor(torch.arange(6, dtype=torch.int8).reshape(2, 3),
                         torch.ones(2, 1), 8, None, (2, 3))
    opt = {"step": 7, "mu": [torch.zeros(3), None], "q": qt}
    ck = Checkpointer(str(tmp_path))
    ck.save(5, params, opt)
    params["final_norm"]["gain"].add_(1.0)     # after the snapshot
    ck.wait()
    assert set(ck.timings) == {"d2h_ms", "write_ms"}
    p, o, step = ck.restore(5, template=(params, opt), device="cpu")
    assert step == 5 and o["mu"][1] is None and isinstance(o["q"],
                                                           QuantizedTensor)
    assert int(o["step"]) == 7 and o["step"].dtype == torch.int64
    np.testing.assert_array_equal(o["q"].data.numpy(), qt.data.numpy())
    assert torch.equal(p["final_norm"]["gain"],
                       torch.ones_like(p["final_norm"]["gain"]))
    raw_p, raw_o, _ = ck.restore_latest(device="cpu")
    assert isinstance(raw_o["q"], list) and len(raw_o["q"]) == 2
    assert isinstance(raw_p["stack"]["list"], list)


def test_corrupt_payload_fails_its_crc(tmp_path):
    """A flipped byte in a member's payload is caught by the zip CRC, as
    ``np.load`` catches it."""
    model, params, _ = _tiny()
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, params)
    path = str(tmp_path / "step_00000001" / "shard_00000.npz")
    with zipfile.ZipFile(path) as zf:
        info = zf.getinfo("params::final_norm/gain.npy")
    with open(path, "r+b") as f:
        f.seek(info.header_offset + 26)       # the local header's lengths
        name_len, extra_len = struct.unpack("<HH", f.read(4))
        # past the local header and the .npy header (128 bytes) into data
        f.seek(info.header_offset + 30 + name_len + extra_len + 128 + 8)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        ck.restore_serving(device="cpu")
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        np.load(path)["params::final_norm/gain"]


def test_reshard_arguments_not_ported(tmp_path):
    model, params, _ = _tiny()
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, params)
    with pytest.raises(NotImplementedError, match="M7"):
        ck.restore_serving(mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="M7"):
        ck.restore(1, shardings=(None, None), template=(params, {}))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _jax_trees():
    """(name, tree, quant_meta) cases the reference writes."""
    out = []
    for scan in (True, False):
        p = _jax_tiny(scan=scan)
        tag = "stacked" if scan else "unrolled"
        out.append((f"fp-{tag}", p, None))
        for bits in (8, 4):
            q, m = japply.quantize_params_serving(p, bits, "squant")
            out.append((f"w{bits}-{tag}", q, m))
    out.append(("fp-bf16-embedding", _jax_tiny(dtype="bfloat16"), None))
    return out


_JAX_TREES = None


def _jax_case(name):
    global _JAX_TREES
    if _JAX_TREES is None:
        _JAX_TREES = {n: (t, m) for n, t, m in _jax_trees()}
    return _JAX_TREES[name]


_CASES = ["fp-stacked", "w8-stacked", "w4-stacked", "fp-unrolled",
          "w8-unrolled", "w4-unrolled", "fp-bf16-embedding"]


@pytest.mark.parametrize("case", _CASES)
def test_reference_writes_port_reads(tmp_path, case):
    tree, meta = _jax_case(case)
    JCheckpointer(str(tmp_path), async_save=False).save_serving(
        2, tree, quant_meta=meta)
    restored, m, step = Checkpointer(str(tmp_path)).restore_serving(
        device="cpu")
    assert step == 2 and m["quant"] == meta
    _assert_trees_equal(jax.device_get(tree), restored)
    if case == "fp-bf16-embedding":
        assert restored["embedding"]["embedding"].dtype == torch.bfloat16


def test_reference_training_save_port_reads(tmp_path):
    p = _jax_tiny(scan=True)
    opt = {"m": jnp.zeros(3), "count": 4}
    JCheckpointer(str(tmp_path), async_save=False).save(9, p, opt)
    ck = Checkpointer(str(tmp_path))
    tp = convert._convert(jax.device_get(p), "cpu")
    params, o, _ = ck.restore(9, template=(tp, {"m": 0, "count": 0}),
                              device="cpu")
    _assert_trees_equal(jax.device_get(p), params)
    assert int(o["count"]) == 4
    raw, raw_opt, _ = ck.restore_latest(device="cpu")
    _assert_trees_equal(jax.device_get(p), raw)


@pytest.mark.parametrize("case", ["fp-stacked", "w8-stacked", "w4-unrolled"])
def test_port_writes_reference_reads(tmp_path, case):
    tree, meta = _jax_case(case)
    ttree = convert._convert(jax.device_get(tree), "cpu")
    Checkpointer(str(tmp_path), async_save=False).save_serving(
        4, ttree, quant_meta=meta)
    jck = JCheckpointer(str(tmp_path), async_save=False)
    restored, m, step = jck.restore_serving(expect=None)
    assert step == 4 and m["quant"] == meta
    _assert_trees_equal(jax.device_get(tree), jax.device_get(restored))
    raw, _, _ = jck._restore_raw(4, to_jax=False)
    _assert_trees_equal(jax.device_get(tree), raw)


def _members(npz_path):
    with zipfile.ZipFile(npz_path) as zf:
        return [(i.filename, zf.read(i.filename)) for i in zf.infolist()]


@pytest.mark.parametrize("case", _CASES)
def test_same_tree_same_files(tmp_path, case):
    """index.json (but the commit time) and every npz member, name, header
    and bytes, equal to the reference's for the same tree."""
    tree, meta = _jax_case(case)
    jd, td = tmp_path / "jax", tmp_path / "torch"
    JCheckpointer(str(jd), async_save=False).save_serving(1, tree,
                                                          quant_meta=meta)
    Checkpointer(str(td), async_save=False).save_serving(
        1, convert._convert(jax.device_get(tree), "cpu"), quant_meta=meta)
    step = "step_00000001"
    with open(jd / step / "index.json") as f:
        jmeta = f.read()
    with open(td / step / "index.json") as f:
        tmeta = f.read()
    assert tmeta == jmeta
    idx = json.loads(tmeta)
    assert set(idx) == {"step", "trees", "format", "quant", "shapes",
                        "dtypes"}
    assert all(not d.startswith("torch") for d in idx["dtypes"].values())
    assert _members(td / step / "shard_00000.npz") == \
        _members(jd / step / "shard_00000.npz")
    if case == "fp-bf16-embedding":
        assert idx["dtypes"]["params::embedding/embedding"] == "bfloat16"
        with zipfile.ZipFile(td / step / "shard_00000.npz") as zf:
            head = zf.read("params::embedding/embedding.npy")[:64]
        assert b"'descr': '<V2'" in head


def test_bf16_leaf_restores_in_the_port_not_in_the_reference(tmp_path):
    """The port restores a bfloat16 leaf written by either package bit for
    bit; the reference cannot restore its own (``jnp.asarray`` of a ``|V2``
    array). That is the reference's behaviour, recorded, not changed."""
    tree, _ = _jax_case("fp-bf16-embedding")
    ttree = convert._convert(jax.device_get(tree), "cpu")
    for writer in ("jax", "torch"):
        d = str(tmp_path / writer)
        if writer == "jax":
            JCheckpointer(d, async_save=False).save_serving(1, tree)
        else:
            Checkpointer(d, async_save=False).save_serving(1, ttree)
        restored, _, _ = Checkpointer(d).restore_serving(device="cpu")
        _assert_trees_equal(ttree, restored)
        with pytest.raises(TypeError, match="V2"):
            JCheckpointer(d, async_save=False).restore_serving()


def test_zero_d_leaf_keeps_its_shape_both_ways(tmp_path):
    """An AdamW step counter (a 0-d int32 tensor) is written as a 0-d
    member, as ``np.savez`` writes the reference's, and comes back 0-d in
    both packages (``np.ascontiguousarray`` alone would make it 1-d)."""
    p = {"w": torch.ones(2, 2)}
    opt = {"m": {"w": torch.zeros(2, 2)}, "v": {"w": torch.zeros(2, 2)},
           "step": torch.tensor(3, dtype=torch.int32)}
    Checkpointer(str(tmp_path), async_save=False).save(1, p, opt)
    _, o, _ = Checkpointer(str(tmp_path)).restore(1, template=(p, opt),
                                                  device="cpu")
    assert o["step"].shape == () and o["step"].dtype == torch.int32
    jopt = {"m": {"w": jnp.zeros((2, 2))}, "v": {"w": jnp.zeros((2, 2))},
            "step": jnp.zeros((), jnp.int32)}
    _, jo, _ = JCheckpointer(str(tmp_path)).restore(
        1, template=({"w": jnp.zeros((2, 2))}, jopt))
    assert jo["step"].shape == () and int(jo["step"]) == 3
