"""Port vs reference: checkpoint hot-reload (``WeightStore.poll_checkpoints``
/ ``watch`` / ``close``, ``ServeEngine.watch_checkpoints``).

The reference's cases (``tests/test_weight_store.py``: fp checkpoints
quantized on the fly, quantized checkpoints served natively, torn and
corrupt steps skipped, metadata mismatches rejected once, transient
failures retried, a live reload with zero failed requests, an engine from a
prebuilt qdict store) on the port, plus: the port's engine and the
reference's serve the same restored qdict checkpoint with equal greedy
tokens, on the round path and on the continuous paged chunked path; a
speculative store keeps its (target, draft) pair when a quantized
checkpoint arrives. The card's cases (a reload staged while the scheduler
captures, a synchronization during a capture) are in
``tests/test_torch_reload_cuda.py``.
"""
import dataclasses
import os
import threading
import time

import jax
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import get_config as jax_get_config
from repro.models.model import build_model as jax_build_model
from repro.quant import apply as japply
from repro.serving import engine as jeng
from repro.serving.weights import WeightStore as JWeightStore
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.quant.apply import quantize_params_serving
from repro_torch.serving.engine import Request, ServeConfig, ServeEngine
from repro_torch.serving.weights import WeightStore

torch.set_num_threads(1)

_TINY = dict(dtype="float32", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=1, head_dim=16, d_ff=64, vocab=64)
W8 = dict(max_batch=2, max_len=32, quantize_weights="squant", weight_bits=8)
EXPECT = {"quantize_weights": "squant", "weight_bits": 8}


def _tiny(seed=0):
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **_TINY)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(seed),
                             device="cpu"), cfg


def _reqs(n, max_new=4):
    return [Request(prompt=[1 + i % 5, 2, 3], max_new_tokens=max_new,
                    request_id=i) for i in range(n)]


def _engine(model, params, **kw):
    return ServeEngine(model, params, ServeConfig(**dict(W8, **kw)),
                       device="cpu")


def test_watcher_quantizes_fp_checkpoints_on_the_fly(tmp_path):
    model, params, _ = _tiny(0)
    _, params2, _ = _tiny(1)
    eng = _engine(model, params)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, params2, {"m": torch.zeros(1)})     # training-style fp save
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) == 1
    out = eng.generate(_reqs(2))
    assert all(o.weights_version == 2 for o in out)
    cur = eng.store.current
    assert cur.source == "ckpt:1" and cur.step == 1
    assert cur.report is not None            # re-quantized via quantize_tree
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) is None


def test_watcher_loads_quantized_checkpoints_natively(tmp_path):
    model, params, _ = _tiny(0)
    _, params2, _ = _tiny(1)
    qtree, meta = quantize_params_serving(params2, 8, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(5, qtree, quant_meta=meta)
    eng = _engine(model, params)
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) == 5
    out = eng.generate(_reqs(2))
    assert all(o.weights_version == 2 for o in out)
    assert all(len(o.tokens) == 4 for o in out)
    cur = eng.store.current
    assert cur.report is None                  # no re-quantization
    wq = cur.params["stack"]["list"][0]["b0"]["attn"]["wq"]
    assert set(wq) == {"w_q", "w_scale"}
    assert torch.equal(wq["w_q"], qtree["stack"]["list"][0]["b0"]["attn"]
                       ["wq"]["w_q"])


def _break_step(dirname, mode):
    if mode == "torn":
        os.remove(os.path.join(dirname, "COMMITTED"))
    else:
        with open(os.path.join(dirname, "index.json"), "w") as f:
            f.write('{"step": 3, "trees": {')       # truncated json


@pytest.mark.parametrize("kind", ["fp", "quantized"])
def test_watcher_skips_torn_and_corrupt_steps(tmp_path, kind):
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
    _break_step(str(tmp_path / "step_00000002"), "torn")
    _break_step(str(tmp_path / "step_00000003"), "corrupt")
    assert ck.list_steps() == [1]
    eng = _engine(model, params)
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) == 1
    assert not eng.store.errors
    save(4, params2)
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) == 4
    out = eng.generate(_reqs(2))
    assert all(o.weights_version == 3 for o in out)     # init + 2 reloads


def test_watcher_rejects_meta_mismatch(tmp_path):
    model, params, _ = _tiny(0)
    qtree, meta = quantize_params_serving(params, 4, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    eng = _engine(model, params)
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) is None
    assert eng.store.version == 1
    errs = eng.store.stats()["errors"]
    assert errs and "mismatch" in errs[0] and "rejected" in errs[0]
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) is None
    assert len(eng.store.errors) == 1


def test_watcher_retries_transient_failures(tmp_path):
    model, params, _ = _tiny(0)
    _, params2, _ = _tiny(1)
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(1, params2, {"m": torch.zeros(1)})
    eng = _engine(model, params)
    orig, flaked = ck.restore_serving, []

    def flaky(*a, **kw):
        if not flaked:
            flaked.append(True)
            raise OSError("disk hiccup")
        return orig(*a, **kw)

    ck.restore_serving = flaky
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) is None
    assert "retries left" in eng.store.errors[-1]
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) == 1   # retried
    assert eng.store.wait_staged(version=1, timeout=30)
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) is None


@pytest.mark.parametrize("scheduler", ["round", "continuous"])
def test_live_reload_zero_failed_requests(tmp_path, scheduler):
    model, params, _ = _tiny(0)
    _, params2, _ = _tiny(1)
    kw = {} if scheduler == "round" else dict(
        scheduler="continuous", kv_backend="paged", block_size=8,
        prefill_chunk=2, dequantize_for_compute=False)
    eng = _engine(model, params, **kw)
    eng.watch_checkpoints(str(tmp_path), poll_s=0.02)
    assert eng.stats()["weights"]["watching"]
    ck = Checkpointer(str(tmp_path), async_save=False)

    def writer():
        time.sleep(0.05)
        ck.save(1, params2, {"m": torch.zeros(1)})

    th = threading.Thread(target=writer)
    th.start()
    outs = []
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        outs.extend(eng.generate(_reqs(4, max_new=3)))
        if outs[-1].weights_version >= 2:
            break
    th.join(timeout=30)
    assert not th.is_alive()
    assert outs[-1].weights_version >= 2, "reload never landed"
    assert all(len(o.tokens) == 3 for o in outs)
    if scheduler == "round":
        versions = [e["version"] for e in eng.stats()["round_log"]]
    else:
        versions = [o.weights_version for o in outs]
    assert versions == sorted(versions)                     # monotonic
    st = eng.stats()["weights"]
    assert st["swaps"] >= 1 and st["version"] >= 2
    assert st["source"] == "ckpt:1"
    assert not st["errors"]
    eng.close()
    assert not eng.store.stats()["watching"]


def test_engine_from_prebuilt_qdict_store():
    model, params, _ = _tiny(0)
    qtree, _ = quantize_params_serving(params, 8, "squant")
    store = WeightStore(serving_params=qtree, source="prequantized",
                        device="cpu")
    eng = ServeEngine(model, cfg=ServeConfig(max_batch=2, max_len=32),
                      store=store, device="cpu")
    out = eng.generate(_reqs(2))
    assert all(len(o.tokens) == 4 for o in out)
    assert eng.store.current.source == "prequantized"


def test_speculative_store_keeps_its_pair_on_a_quantized_checkpoint(
        tmp_path):
    model, params, _ = _tiny(0)
    qtree, meta = quantize_params_serving(params, 8, "squant")
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    eng = _engine(model, params, scheduler="continuous", kv_backend="paged",
                  block_size=8, speculative=True, draft_k=2,
                  dequantize_for_compute=False)
    live = eng.store.current
    assert eng.store.poll_checkpoints(ck, expect=EXPECT) is None
    assert eng.store.current is live and live.draft_params is not None
    assert "cannot rebuild the drafter" in eng.store.errors[-1]
    assert all(len(o.tokens) == 4 for o in eng.generate(_reqs(2)))


def test_mesh_is_not_ported(tmp_path):
    model, params, _ = _tiny(0)
    eng = _engine(model, params)
    with pytest.raises(NotImplementedError, match="M7"):
        eng.watch_checkpoints(str(tmp_path), mesh=object())
    with pytest.raises(NotImplementedError, match="M7"):
        eng.store.poll_checkpoints(Checkpointer(str(tmp_path)),
                                   mesh=object())
    assert not eng.stats()["weights"]["watching"]


# ---------------------------------------------------------------------------
# the port's engine and the reference's on one restored qdict checkpoint
# ---------------------------------------------------------------------------

PROMPTS = [[1, 2, 3], [5], [7, 8, 9, 10, 11], [20, 21]]
NEW = [6, 4, 5, 3]


@pytest.fixture(scope="module")
def shared_ckpt(tmp_path_factory):
    """A w8 qdict checkpoint the reference wrote, of its tiny model."""
    cfg = dataclasses.replace(jax_get_config("granite-3-8b", reduced=True),
                              scan_layers=False, **_TINY)
    jmodel = jax_build_model(cfg)
    qtree, meta = japply.quantize_params_serving(
        jmodel.init(jax.random.PRNGKey(0)), 8, "squant")
    d = str(tmp_path_factory.mktemp("shared"))
    JCheckpointer(d, async_save=False).save_serving(1, qtree,
                                                    quant_meta=meta)
    return d, jmodel


@pytest.mark.parametrize("paged", [False, True])
def test_port_and_reference_engines_agree_on_a_restored_checkpoint(
        shared_ckpt, paged):
    d, jmodel = shared_ckpt
    kw = dict(max_batch=4, max_len=32)
    if paged:
        kw.update(scheduler="continuous", kv_backend="paged", block_size=8,
                  prefill_chunk=3, max_slots=3)
    jtree, _, _ = JCheckpointer(d, async_save=False).restore_serving()
    je = jeng.ServeEngine(jmodel, cfg=jeng.ServeConfig(**kw),
                          store=JWeightStore(serving_params=jtree))
    ttree, _, _ = Checkpointer(d).restore_serving(device="cpu")
    tmodel = build_model(dataclasses.replace(
        get_config("granite-3-8b", reduced=True), **_TINY))
    te = ServeEngine(tmodel, cfg=ServeConfig(**kw), device="cpu",
                     store=WeightStore(serving_params=ttree, device="cpu"))
    jout = je.generate([jeng.Request(p, n, request_id=i)
                        for i, (p, n) in enumerate(zip(PROMPTS, NEW))])
    tout = te.generate([Request(p, n, request_id=i)
                        for i, (p, n) in enumerate(zip(PROMPTS, NEW))])
    for jc, tc, n in zip(jout, tout, NEW):
        assert len(tc.tokens) == n
        assert tc.tokens == [int(t) for t in jc.tokens]
