"""The serving-checkpoint slice on a GPU: the ``w_q``/``w_q4`` linear through
kernel B against its plain version, the serving format quantized on the card
equal to the one quantized on the host, a restore onto the card, a reload
staged while the scheduler captures, and what another thread's
synchronization does to a capture. Skipped where there is no CUDA device.
It imports no JAX, so it runs where only PyTorch is installed. Run on a
GPU machine with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_reload_cuda.py``.
"""
import dataclasses
import os
import sys

import pytest
import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.models import layers
from repro_torch.models.model import build_model
from repro_torch.quant import apply
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine

pytestmark = pytest.mark.gpu

_TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _tiny_model():
    return build_model(dataclasses.replace(
        get_config("granite-3-8b", reduced=True), **_TINY))


@pytest.mark.parametrize("rows", [8, 64])
@pytest.mark.parametrize("bits", [8, 4])
def test_qdict_linear_kernel_equals_plain(dev, bits, rows):
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((1024, 512), generator=gen, device=dev) / 32
    tq = apply.quantize_params_serving({"p": {"w": w}}, bits)[0]["p"]
    x = torch.randn((rows, 1024), generator=gen, device=dev).to(torch.bfloat16)
    before = dm.launches
    y = layers.linear(tq, x)
    assert dm.launches == before + 1
    with ops.force_backend("ref"):
        r = layers.linear(tq, x)
    torch.testing.assert_close(y.float(), r.float(), rtol=2e-2, atol=2e-2)
    # the tree quantized on the card (kernel A) equals the host's
    cpu = apply.quantize_params_sharded({"p": {"w": w.cpu()}}, bits)["p"]
    for k, v in cpu.items():
        assert torch.equal(tq[k].cpu(), v), k


@pytest.mark.parametrize("bits", [8, 4])
def test_restore_onto_the_card(tmp_path, dev, bits):
    params = _tiny_model().init(torch.Generator(device=dev).manual_seed(0),
                                device=dev)
    params["embedding"]["embedding"] = \
        params["embedding"]["embedding"].to(torch.bfloat16)
    qtree, meta = apply.quantize_params_serving(params, bits, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    restored, _, _ = ck.restore_serving()             # default: the card

    def flat(t, p=()):
        if isinstance(t, dict):
            return {k2: v2 for k in t for k2, v2 in flat(t[k], p + (k,)).items()}
        if isinstance(t, list):
            return {k2: v2 for i, v in enumerate(t)
                    for k2, v2 in flat(v, p + (str(i),)).items()}
        return {"/".join(p): t}

    a, b = flat(qtree), flat(restored)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].device == dev and b[k].dtype == a[k].dtype, k
        assert torch.equal(a[k].view(torch.int16) if a[k].dtype ==
                           torch.bfloat16 else a[k],
                           b[k].view(torch.int16) if b[k].dtype ==
                           torch.bfloat16 else b[k]), k


def test_device_sync_during_a_capture(dev):
    """What the staging thread must not do: a device-wide synchronization
    while another thread captures (``thread_local``), recorded either way;
    a synchronization of the thread's own stream leaves the capture
    intact."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from chip_smoke import run_capture_sync_probe
    out = run_capture_sync_probe()                 # a process of its own
    assert out["stream_sync"]["capture_ok"], out
    assert out["stream_sync"]["other_thread_error"] is None, out


def test_reload_while_capturing(tmp_path, dev):
    model = _tiny_model()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    qtree, meta = apply.quantize_params_serving(params, 8, "squant")
    eng = ServeEngine(model, params, ServeConfig(
        max_batch=2, max_len=32, quantize_weights="squant", weight_bits=8,
        scheduler="continuous", kv_backend="paged", block_size=8,
        prefill_chunk=4, max_slots=2, dequantize_for_compute=False),
        device=dev)
    Checkpointer(str(tmp_path), async_save=False).save_serving(
        1, qtree, quant_meta=meta)
    outs = eng.generate([Request([1, 2, 3], 3)])     # captures on v1
    eng.watch_checkpoints(str(tmp_path), poll_s=0.01)
    for i in range(50):
        outs += eng.generate([Request([1 + j for j in range(1 + (i + k) % 7)],
                                      3, request_id=k) for k in range(3)])
        if outs[-1].weights_version >= 2:
            break
    eng.close()
    assert outs[-1].weights_version == 2 and not eng.store.errors
    assert all(len(o.tokens) == 3 for o in outs)
    assert eng.trace_counts["decode"] >= 2           # recaptured after the swap
