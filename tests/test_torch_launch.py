"""The port's CLIs (``repro_torch.launch.quantize`` / ``serve``), their
``main()`` with ``--device cpu`` at the reduced config: quantize writes the
report, an fp checkpoint and a native serving checkpoint that the reference
package restores; serve ``--reload-from`` swaps that checkpoint in live.
Also the byte tokenizer against the reference's."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro_torch.checkpoint import Checkpointer
from repro_torch.data import ByteTokenizer
from repro_torch.launch import quantize as qcli
from repro_torch.launch import serve as scli

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out, serving = str(d / "out"), str(d / "serving")
    qcli.main(["--bits", "8", "--device", "cpu", "--out", out,
               "--serving-ckpt", serving])
    return out, serving


def test_quantize_writes_report_fp_and_serving_checkpoints(quantized):
    out, serving = quantized
    with open(os.path.join(out, "quant_report.json")) as f:
        rep = json.load(f)
    assert set(rep) == {"method", "bits", "backend", "batched", "total_ms",
                        "dispatch_ms", "sync_ms", "mesh_axis", "mesh_size",
                        "shards", "buckets", "layers"}
    assert rep["method"] == "squant" and rep["bits"] == 8
    assert rep["backend"] == "ref" and len(rep["layers"]) == 28
    params, opt, step = Checkpointer(out).restore_latest(device="cpu")
    assert step == 0 and int(opt["step"]) == 0
    assert params["stack"]["list"][0]["b0"]["attn"]["wq"]["w"].dtype == \
        torch.float32
    tree, meta, step = Checkpointer(serving).restore_serving(device="cpu")
    assert step == 0 and meta["format"] == "quantized"
    assert meta["quant"]["bits"] == 8 and meta["quant"]["method"] == "squant"
    assert meta["quant"]["leaf_format"] == "w_q+w_scale"


def test_reference_restores_the_cli_serving_checkpoint(quantized):
    _, serving = quantized
    jtree, meta, step = JCheckpointer(serving, async_save=False) \
        .restore_serving(expect={"quantize_weights": "squant",
                                 "weight_bits": 8})
    ttree, _, _ = Checkpointer(serving).restore_serving(device="cpu")
    flat = jax.tree_util.tree_flatten_with_path(jax.device_get(jtree))[0]
    assert len(flat) == 2 + 4 * 7 * 2 + 4 * 2     # emb, norm, qdicts, lns
    for kp, a in flat:
        node = ttree
        for k in kp:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        np.testing.assert_array_equal(node.numpy(), np.asarray(a))


def test_serve_reload_from_swaps_the_checkpoint_in(quantized, capsys):
    _, serving = quantized
    scli.main(["--quantize", "squant", "--bits", "8", "--scheduler",
               "continuous", "--kv-backend", "paged", "--reload-from",
               serving, "--reload-poll", "0.01", "--rounds", "3",
               "--max-new", "8", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] watching" in out and "reload error" not in out
    line = [ln for ln in out.splitlines() if "scheduler=continuous" in ln]
    assert line and "source ckpt:0" in line[0] and "weights v2" in line[0]
    assert "paged kv:" in out
    rounds = [ln for ln in out.splitlines() if ln.startswith("[serve] round")]
    assert len(rounds) == 3


def test_serve_round_and_speculative(capsys):
    scli.main(["--quantize", "squant", "--bits", "8", "--max-new", "4",
               "--prompts", "hi", "there", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] squant w8:" in out and "scheduler=round" in out
    scli.main(["--quantize", "squant", "--bits", "8", "--scheduler",
               "continuous", "--kv-backend", "paged", "--speculative",
               "--draft-k", "2", "--max-new", "4", "--device", "cpu"])
    assert "[serve] speculative:" in capsys.readouterr().out


def test_mesh_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="M7"):
        qcli.main(["--mesh", "2", "--device", "cpu", "--out",
                   str(tmp_path)])


def test_byte_tokenizer_equals_reference():
    t, j = ByteTokenizer(), JByteTokenizer()
    for text in ("hello world", "ünï cødé", ""):
        assert t.encode(text) == j.encode(text)
        assert t.encode(text, add_bos=False) == j.encode(text, add_bos=False)
        ids = t.encode(text) + [t.eos_id, t.pad_id]
        assert t.decode(ids) == j.decode(ids) == text
    assert (t.vocab_size, t.pad_id, t.bos_id, t.eos_id) == \
        (j.vocab_size, j.pad_id, j.bos_id, j.eos_id)
