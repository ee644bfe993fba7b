"""Mixture-of-experts on the card: kernel A on expert banks read where
they are stored (the native route, bit-identical to the stacked route and
to the plain version), kernel B once per expert on zero-copy views of a
bank (against the plain version; ``tcgemv`` up to 16 rows of capacity,
``mma`` above), and ``moe_ffn`` captured as a CUDA graph. Skipped where
there is no CUDA device; no JAX (the card's machine has none). Run on a GPU
machine with ``PYTHONPATH=src python -m pytest -q -m gpu
tests/test_torch_moe_cuda.py``."""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bank(dev, gen, e, din, dout):
    return {"w": torch.randn((e, din, dout), generator=gen, device=dev)
            / din ** 0.5}


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("e,din,dout", [(8, 256, 128), (4, 1408, 2048),
                                        (3, 300, 33)])
def test_native_route_on_expert_banks_equals_stacked_and_plain(dev, bits, e,
                                                               din, dout):
    from repro_torch.core import pipeline
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(e + din)
    tree = {"wi": _bank(dev, gen, e, din, dout),
            "wg": _bank(dev, gen, e, din, dout),
            "attn": {"w": torch.randn((din, 64), generator=gen, device=dev)}}
    n0 = sf.launches
    got, rep = pipeline.quantize_tree(tree, bits=bits, group_size=128,
                                      device=dev)
    assert sf.launches - n0 == 2
    assert {b.route for b in rep.buckets} == {"native"}
    want, rw = pipeline.quantize_tree(tree, bits=bits, group_size=128,
                                      device=dev, backend="ref")
    assert {b.route for b in rw.buckets} == {"stacked"}
    cpu, _ = pipeline.quantize_tree({k: {"w": v["w"].cpu()} for k, v in
                                     tree.items()}, bits=bits,
                                    group_size=128, device="cpu")
    for k in tree:
        a, b, c = got[k]["w"], want[k]["w"], cpu[k]["w"]
        assert a.shape == b.shape == c.shape
        assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
        assert torch.equal(a.data.cpu(), c.data)
        assert torch.equal(a.scale.cpu(), c.scale)


def test_native_route_more_expert_slices_than_one_launch_takes(dev):
    """A bucket of 2 x 256 expert slices: the leaf table is split across
    launches (``MAX_LEAVES`` a launch), the codes equal the plain ones."""
    from repro_torch.core import pipeline
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(1)
    tree = {"a": _bank(dev, gen, 256, 128, 16),
            "b": _bank(dev, gen, 256, 128, 16)}
    n0 = sf.launches
    got, _ = pipeline.quantize_tree(tree, bits=8, group_size=64, device=dev)
    assert sf.launches - n0 == -(-512 // sf.MAX_LEAVES)
    want, _ = pipeline.quantize_tree(tree, bits=8, group_size=64,
                                     device=dev, backend="ref")
    for k in tree:
        assert torch.equal(got[k]["w"].data, want[k]["w"].data)


def _quantized_bank(dev, gen, e, din, dout, bits, form):
    from repro_torch.core import pipeline
    from repro_torch.quant import apply
    bank = _bank(dev, gen, e, din, dout)
    if form == "w_q":
        return apply.quantize_params_sharded({"x": bank}, bits)["x"]
    return pipeline.quantize_tree({"x": bank}, bits=bits, group_size=128,
                                  device=dev)[0]["x"]


@pytest.mark.parametrize("form", ["qt", "w_q"])
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("din,dout", [(2048, 1408), (1408, 2048)])
@pytest.mark.parametrize("c,variant", [(8, "tcgemv"), (1, "tcgemv"),
                                       (47, "mma")])
def test_expert_kernel_b_close_to_plain(dev, form, bits, din, dout, c,
                                        variant):
    """One kernel-B launch per expert on a zero-copy view of the bank:
    every launch of the variant the capacity implies, the result within
    bf16's 2e-2 (relative to the largest output) of the plain version
    (the dequantized bank and ``torch.matmul``) and of the per-expert plain
    dequant-matmul."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    from repro_torch.quant import apply
    e = 4
    gen = torch.Generator(device=dev).manual_seed(din + c)
    bank = _quantized_bank(dev, gen, e, din, dout, bits, form)
    x = torch.randn((e, c, din), generator=gen, device=dev).to(
        torch.bfloat16)
    before = dict(dm.launches_by_variant)
    got = moe.expert_matmul(bank, x)
    torch.cuda.synchronize()
    assert {v: dm.launches_by_variant[v] - before[v]
            for v in before} == {v: e if v == variant else 0
                                 for v in before}
    assert got.shape == (e, c, dout) and got.dtype == torch.bfloat16
    with ops.force_backend("ref"):
        plain = moe.expert_matmul(bank, x)
    views = [apply.expert_view(bank, i, e) for i in range(e)]
    per = torch.stack([dm.dequant_matmul_plain(
        x[i], views[i].data, views[i].scale, bits=bits, group_size=128)
        for i in range(e)])
    for want in (plain, per):
        err = (got.float() - want.float()).abs().max()
        assert float(err) <= 2e-2 * float(want.float().abs().max())


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("din,dout", [(256, 384), (2048, 1408),
                                      (1408, 2048)])
@pytest.mark.parametrize("c,variant", [(5, "tcgemv32"), (47, "mma32")])
def test_expert_kernel_b_float32_close_to_plain(dev, bits, din, dout, c,
                                                variant):
    """float32 activations (phase 10b's): the float32 tensor-core
    instances (three exact bf16 passes), one launch per expert, within
    float32's 1e-4 of the plain version."""
    from repro_torch.kernels import dequant_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(3)
    bank = _quantized_bank(dev, gen, 4, din, dout, bits, "qt")
    x = torch.randn((4, c, din), generator=gen, device=dev)
    before = dm.launches_by_variant[variant]
    got = moe.expert_matmul(bank, x)
    assert dm.launches_by_variant[variant] - before == 4
    with ops.force_backend("ref"):
        want = moe.expert_matmul(bank, x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_ffn_captured_equals_eager(dev, dropless):
    """The whole MoE FFN (routing, dispatch, 3 x E kernel-B launches,
    combine) as one CUDA graph: replays equal the eager call bit for bit,
    also after new inputs are copied into the static buffer."""
    from repro_torch.core import pipeline
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(0)
    p = moe.init_moe(gen, 256, 128, 8, device=dev)
    q, _ = pipeline.quantize_tree(p, bits=8, group_size=128, device=dev)
    x = torch.randn((2, 9, 256), generator=gen, device=dev).to(
        torch.bfloat16)

    def run():
        return moe.moe_ffn(q, x, n_experts=8, top_k=6, dropless=dropless)

    eager = run()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = run()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])
    x.copy_(torch.randn((2, 9, 256), generator=gen, device=dev))
    want = run()
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], want[0])


@pytest.mark.parametrize("dtype,tokens,dropless", [
    (torch.bfloat16, 8, True), (torch.bfloat16, 18, False),
    (torch.float32, 8, True), (torch.float32, 18, False)],
    ids=["tcgemv", "mma", "gemv", "tiled"])
def test_graph_nodes_count_expert_launches_by_shape(dev, dtype, tokens,
                                                    dropless):
    """``moe_ffn`` captured: the graph's kernel-B nodes, read with their
    (M, N) arguments, count what the wrappers counted in the capture, by
    variant and by weight shape: one launch per expert at each bank's
    shape (wi and wg (128, 256), wdown (256, 128))."""
    from repro_torch.core import pipeline
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(tokens)
    p = moe.init_moe(gen, 256, 128, 8, device=dev)
    q, _ = pipeline.quantize_tree(p, bits=8, group_size=128, device=dev)
    x = torch.randn((1, tokens, 256), generator=gen, device=dev).to(dtype)

    def run():
        return moe.moe_ffn(q, x, n_experts=8, top_k=6, dropless=dropless)

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        run()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph(keep_graph=True)
    before = ops.launch_counts()
    with torch.cuda.graph(g):
        run()
    tally = ops.launches_between(before, ops.launch_counts())
    got = ops.graph_launches(g)
    assert got == tally
    shapes = got["dequant_matmul.launches_by_shape"]
    assert len({k.split()[0] for k in shapes}) == 1
    assert {k.split()[1]: n for k, n in shapes.items()} == \
        {"128x256": 16, "256x128": 8}
