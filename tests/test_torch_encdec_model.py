"""Port vs reference: the whole encoder-decoder, reduced
``seamless-m4t-medium`` (2 encoder + 4 decoder layers, d_model 64),
``LM.forward`` in prefill, decode and train modes with random frames, the
loss and its gradients, SQuant codes, the round engine, a serving
checkpoint's round trip and the CLIs.

The reference model is initialised with ``jax.random`` and carried across
with ``convert.from_jax_params`` (its stacked encoder, and its stacked
decoder under ``scan_layers``, unrolled). Tolerances: float32 logits within
1e-4; bfloat16 within 2e-2 of the largest logit, against the reference with
``scan_layers=False`` (its stacked layout cannot carry the float32 encoder
output through a bfloat16 scan), in the reference's output dtypes; the loss
within ``rtol=1e-5`` and its gradients within ``rtol=2e-4, atol=2e-5``;
codes and scales bit for bit; engine tokens equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.pipeline import quantize_tree as jax_quantize_tree
from repro.models.model import build_model as jax_build_model
from repro.serving import engine as jeng
from repro_torch import convert
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config
from repro_torch.core.pipeline import quantize_tree
from repro_torch.launch import quantize as qcli
from repro_torch.launch import serve as scli
from repro_torch.launch import train as tcli
from repro_torch.models.model import build_model
from repro_torch.quant.apply import quantize_params_serving
from repro_torch.quant.qtypes import QuantizedTensor
from repro_torch.serving.api import Request
from repro_torch.serving.engine import ServeConfig, ServeEngine
from repro_torch.serving.weights import WeightStore
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)

ARCH = "seamless-m4t-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
_PAIRS = {}


def _pair(**over):
    """(reference model, its params, port model, the converted params)."""
    key = tuple(sorted(over.items()))
    if key not in _PAIRS:
        kw = dict(dict(dtype="float32", remat=False), **over)
        jc = dataclasses.replace(jax_get_config(ARCH, reduced=True), **kw)
        tc = dataclasses.replace(get_config(ARCH, reduced=True), **kw)
        jm = jax_build_model(jc)
        jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
        _PAIRS[key] = (jm, jp, build_model(tc),
                       convert.from_jax_params(jax.device_get(jp),
                                               device="cpu"))
    return _PAIRS[key]


def _inputs(cfg, b, s, seed=5):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(b, s))
    frames = rng.standard_normal(
        (b, max(1, s // cfg.enc_ratio), cfg.d_model)).astype(np.float32)
    return toks, frames


def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("scan", [True, False])
def test_prefill_and_decode_match_reference(scan):
    """A 24-token prefill over 6 random frames and six greedy decode steps
    (cross K/V recomputed from the cached encoder output each step): logits
    within 1e-4 at every step, the cached encoder output and the clock as
    the reference's, for the reference's stacked and unrolled layouts."""
    jm, jp, tm, tp = _pair(scan_layers=scan)
    b, s = 2, 24
    toks, frames = _inputs(tm.cfg, b, s)
    jl, jc = jax.jit(jm.prefill)(
        jp, {"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(frames)},
        jm.init_cache(b, s + 8))
    tl, tc = tm.prefill(
        tp, {"tokens": torch.from_numpy(toks),
             "enc_frames": torch.from_numpy(frames)},
        tm.init_cache(b, s + 8, device="cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tc["enc_out"].numpy(),
                               np.asarray(jc["enc_out"]), **TOL)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(6):
        tok = np.argmax(np.asarray(jl), axis=-1)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tc["pos"] == s + 6 == int(jc["pos"])


@pytest.mark.parametrize("scan", [True, False])
def test_train_forward_matches_reference(scan):
    jm, jp, tm, tp = _pair(scan_layers=scan)
    toks, frames = _inputs(tm.cfg, 2, 32, seed=3)
    jl, _, _ = jax.jit(jm.forward, static_argnames="mode")(
        jp, {"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(frames)},
        mode="train")
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks),
                            "enc_frames": torch.from_numpy(frames)},
                       mode="train")
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)


def test_encoder_output_given_is_not_recomputed():
    """``batch["enc_out"]`` is used as given (the frames are not read), as
    the reference's ``forward`` does, and lands in the new caches."""
    _, _, tm, tp = _pair(scan_layers=False)
    toks, frames = _inputs(tm.cfg, 2, 16, seed=11)
    enc = tm._encode(tp, {"enc_frames": torch.from_numpy(frames)})
    a, ca = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                            "enc_frames": torch.from_numpy(frames)},
                       tm.init_cache(2, 24, device="cpu"))
    b, cb = tm.prefill(tp, {"tokens": torch.from_numpy(toks), "enc_out": enc},
                       tm.init_cache(2, 24, device="cpu"))
    np.testing.assert_array_equal(b.numpy(), a.numpy())
    assert cb["enc_out"] is enc


@pytest.mark.parametrize("frames_dtype", ["float32", "bfloat16"])
def test_bf16_matches_reference_in_its_dtypes(frames_dtype):
    """The published dtype: a bfloat16 model over float32 frames (the round
    scheduler's) runs its encoder, cross K/V and everything after layer 0's
    cross-attention in float32, its KV cache stays bfloat16 and its logits
    come out float32; over bfloat16 frames it stays bfloat16. Prefill and
    three teacher-forced decode steps within 2e-2 of the largest logit of
    the reference (``scan_layers=False``), every output in the reference's
    dtype."""
    jm, jp, tm, tp = _pair(dtype="bfloat16", scan_layers=False)
    b, s = 2, 16
    toks, frames = _inputs(tm.cfg, b, s, seed=7)
    jfr = jnp.asarray(frames).astype(frames_dtype)
    tfr = torch.from_numpy(frames).to(getattr(torch, frames_dtype))
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks),
                                      "enc_frames": jfr},
                                 jm.init_cache(b, s + 4))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "enc_frames": tfr},
                        tm.init_cache(b, s + 4, device="cpu"))
    assert str(jl.dtype) == frames_dtype == _dtype_name(tl)
    assert _dtype_name(tc["enc_out"]) == str(jc["enc_out"].dtype)
    layer = tc["list"][1]["b0"]
    jlayer = jc["list"][1]["b0"]
    assert _dtype_name(layer["k"]) == str(jlayer["k"].dtype) == "bfloat16"
    jdecode = jax.jit(jm.decode_step)
    for step in range(4):
        w = np.asarray(jl.astype(jnp.float32))
        g = tl.float().numpy()
        assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), step
        if step == 3:
            break
        tok = np.argmax(w, axis=-1)[:, None]
        jl, jc = jdecode(jp, jnp.asarray(tok), jc)
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc)
        assert _dtype_name(tl) == str(jl.dtype) == frames_dtype


def test_reference_stacked_bf16_cannot_carry_float32_frames():
    """The reference's trap, pinned: its stacked (``scan_layers``) bfloat16
    decoder promotes the scan carry to float32 at the first cross-attention
    over float32 frames, and ``lax.scan`` refuses it. The port's layers are
    unrolled and serve the same inputs."""
    jm, jp, tm, tp = _pair(dtype="bfloat16", scan_layers=True)
    toks, frames = _inputs(tm.cfg, 1, 8, seed=2)
    with pytest.raises(TypeError, match="carry"):
        jm.prefill(jp, {"tokens": jnp.asarray(toks),
                        "enc_frames": jnp.asarray(frames)},
                   jm.init_cache(1, 12))
    logits, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                "enc_frames": torch.from_numpy(frames)},
                           tm.init_cache(1, 12, device="cpu"))
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("scan,remat", [(True, True), (False, False)])
def test_train_loss_and_grads_match_reference(scan, remat):
    jm, jp, tm, tp = _pair(scan_layers=scan, remat=remat)
    toks, frames = _inputs(tm.cfg, 2, 32, seed=1)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "enc_frames": frames}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.train_loss, has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, _, tg = tloop._value_and_grad(tm.train_loss, tp,
                                      tloop.to_device(batch, "cpu"))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=0)
    want = convert.from_jax_params(jax.device_get(jg), device="cpu")
    lw, lt = topt.tree_leaves(want), topt.tree_leaves(tg)
    assert len(lw) == len(lt)
    for a, b in zip(lw, lt):
        assert a.shape == b.shape
        np.testing.assert_allclose(b.numpy(), a.numpy(), **GRAD_TOL)
    enc_grads = topt.tree_leaves(tg["encoder"])
    assert any(float(g.abs().max()) > 0 for g in enc_grads)


def _qleaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _qleaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _qleaves(v, path + (str(i),))
    elif isinstance(tree, QuantizedTensor):
        yield path, tree


@pytest.mark.parametrize("scan", [True, False])
def test_quantize_tree_codes_bit_identical_to_reference(scan):
    """SQuant w8 at d_model 256 (grouped g128 buckets beside whole-row
    ones): the port quantizes each encoder layer's leaves on their own; the
    reference quantizes each stacked encoder leaf (and, under
    ``scan_layers``, each stacked decoder leaf) as one bank. SQuant and the
    scales work row by row, so every leaf's codes and scales equal the
    bank's rows for its layer, bit for bit; norms and the embedding are
    left as they are."""
    jm, jp, tm, tp = _pair(d_model=256, d_ff=256, scan_layers=scan)
    jq, _ = jax_quantize_tree(jp, method="squant", bits=8)
    tq, trep = quantize_tree(tp, method="squant", bits=8, device="cpu")
    want = dict(_qleaves(convert.from_jax_params(jax.device_get(jq),
                                                 device="cpu")))
    got = dict(_qleaves(tq))
    assert sorted(want) == sorted(got)
    assert sum(p[0] == "encoder" for p in got) == 2 * 6
    assert sum("xattn" in p for p in got) == 4 * 4
    for path, a in want.items():
        b = got[path]
        assert b.shape == a.shape and b.group_size == a.group_size, path
        assert np.array_equal(b.data.numpy(), a.data.numpy()), path
        assert np.array_equal(b.scale.numpy(), a.scale.numpy()), path
    groups = {lr.bucket.split()[-1] for lr in trep.layers}
    assert groups == {"g128", "gNone"}


def _requests():
    return [Request([7, 3, 9, 11, 2, 5, 8, 1], 6, request_id=0),
            Request([12, 6, 2, 9, 30], 6, request_id=1),
            Request([4, 4, 18, 3, 21, 9, 10, 2, 6, 1, 17], 5, request_id=2)]


def _jax_requests(reqs):
    return [jeng.Request(list(r.prompt), r.max_new_tokens,
                         request_id=r.request_id) for r in reqs]


def test_round_engine_real_quantized_tokens_equal_reference_fake_quantized():
    """Two rounds (max_batch 2) on the round scheduler, SQuant w8: the
    port's real-quantized engine (codes through kernel B's plain version)
    against the reference's fake-quantized float32 engine on its stacked
    tree (the reference cannot scan over QuantizedTensor leaves): tokens
    equal request by request. The scheduler feeds zero frames, so these
    tokens test the decoder; the encoder is held above on random frames."""
    jm, jp, tm, tp = _pair()
    kw = dict(max_batch=2, max_len=32, quantize_weights="squant",
              weight_bits=8)
    reqs = _requests()
    want = {c.request_id: [int(t) for t in c.tokens] for c in
            jeng.ServeEngine(jm, jp, jeng.ServeConfig(
                **kw, dequantize_for_compute=True)).generate(
                    _jax_requests(reqs))}
    eng = ServeEngine(tm, tp, ServeConfig(**kw, dequantize_for_compute=False),
                      device="cpu")
    leaf = eng.params["encoder"]["layers"][1]["attn"]["wv"]["w"]
    assert isinstance(leaf, QuantizedTensor)
    got = {c.request_id: [int(t) for t in c.tokens]
           for c in eng.generate(reqs)}
    assert eng.stats()["scheduler"].rounds == 2
    eng.close()
    assert got == want


def test_round_engine_bf16_decodes_in_float32_after_the_cross_attention():
    """A bfloat16 model on the round scheduler, real-quantized: the
    scheduler's float32 zero frames make the prefill's and every decode
    step's logits float32, and the cached encoder output float32, as the
    reference's unrolled engine computes them."""
    _, _, tm, tp = _pair(dtype="bfloat16", scan_layers=False)
    eng = ServeEngine(tm, tp, ServeConfig(
        max_batch=2, max_len=32, quantize_weights="squant", weight_bits=8,
        dequantize_for_compute=False), device="cpu")
    seen = []

    def spy(fn):
        def call(params, batch, caches):
            logits, caches = fn(params, batch, caches)
            seen.append((logits.dtype, caches["enc_out"].dtype))
            return logits, caches
        return call

    eng._prefill, eng._decode = spy(eng._prefill), spy(eng._decode)
    outs = eng.generate(_requests()[:2])
    eng.close()
    assert all(len(o.tokens) == 6 for o in outs)
    assert len(seen) == 1 + 6
    assert set(seen) == {(torch.float32, torch.float32)}


def test_serving_checkpoint_round_trip_serves_the_same_tokens(tmp_path):
    """``quant.apply`` (the ``w_q`` + ``w_scale`` serving format, encoder
    layers included) → ``Checkpointer.save_serving`` → ``restore_serving``
    → the round engine: tokens equal to the never-saved tree's."""
    _, _, tm, tp = _pair()
    qtree, meta = quantize_params_serving(tp, 8, "squant")
    assert "w_q" in qtree["encoder"]["layers"][0]["ffn"]["wi"]
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save_serving(1, qtree, quant_meta=meta)
    restored, rmeta, step = ck.restore_serving(device="cpu")
    assert step == 1 and rmeta["format"] == "quantized"
    cfg = ServeConfig(max_batch=2, max_len=32)
    toks = []
    for tree in (qtree, restored):
        eng = ServeEngine(tm, cfg=cfg, store=WeightStore(
            serving_params=tree, device="cpu"), device="cpu")
        toks.append([list(c.tokens) for c in eng.generate(_requests())])
        eng.close()
    assert toks[0] == toks[1]
    assert all(len(t) > 0 for t in toks[0])


def test_train_cli_trains_seamless_on_frames(tmp_path, capsys):
    """``launch/train --arch seamless-m4t-medium`` at the reduced config:
    the generator yields float32 ``enc_frames`` (the reference CLI's
    ``encdec_dim``/``enc_ratio``), the Trainer moves them to the device,
    the loss is finite and the run checkpoints."""
    tcli.main(["--arch", ARCH, "--steps", "3", "--batch", "2", "--seq", "16",
               "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("[train] done")]
    assert line and "(3 steps" in line[0]
    first, last = (float(v) for v in
                   line[0].split("loss ")[1].split(" (")[0].split(" → "))
    assert np.isfinite(first) and np.isfinite(last)
    assert Checkpointer(str(tmp_path)).list_steps() == [3]


def test_serve_and_quantize_clis_take_seamless(tmp_path, capsys):
    """``launch/quantize`` writes seamless's report and serving checkpoint;
    ``launch/serve`` serves seamless quantized on the round scheduler and
    refuses the continuous scheduler with the gate's message."""
    serving = str(tmp_path / "serving")
    qcli.main(["--arch", ARCH, "--bits", "8", "--device", "cpu", "--out",
               str(tmp_path / "out"), "--serving-ckpt", serving])
    assert "[quantize] wrote serving checkpoint" in capsys.readouterr().out
    scli.main(["--arch", ARCH, "--quantize", "squant", "--bits", "8",
               "--max-new", "4", "--prompts", "hi", "there", "--device",
               "cpu"])
    out = capsys.readouterr().out
    assert "scheduler=round" in out and "[serve] round 0 req 1" in out
    with pytest.raises(NotImplementedError,
                       match="continuous scheduler does not support "
                             "encoder-decoder models"):
        scli.main(["--arch", ARCH, "--scheduler", "continuous", "--quantize",
                   "squant", "--bits", "8", "--device", "cpu"])
