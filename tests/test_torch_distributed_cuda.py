"""The distributed layer on a GPU: kernel A and its scale pass on column
ranges of stored leaves (how a rank's row slab is read) against their plain
versions, ``quantize_tree(mesh=)`` on a one-rank NCCL mesh and on two ranks
sharing the card over gloo bit-equal to ``mesh=None``, a restore onto the
mesh byte-equal, and the int8 ring on CUDA tensors over gloo equal to the
same ring on the host. Skipped where there is no CUDA device. It imports no
JAX. Run on a GPU machine with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_distributed_cuda.py``.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("c0,n", [(0, 384), (128, 256), (2, 130), (5, 3),
                                  (380, 4)])
def test_column_ranges_equal_plain(dev, c0, n):
    from repro_torch.kernels import squant_flip as sf
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = [torch.randn((512, 384), generator=gen, device=dev)
              for _ in range(3)]
    before = dict(sf.launches_by_route)
    sc = sf.squant_scales(leaves, 8, cols=(c0, n))
    want_sc = sf.squant_scales_plain([x.cpu() for x in leaves], 8,
                                     cols=(c0, n))
    assert torch.equal(sc.cpu(), want_sc)
    codes = sf.squant_flip_leaves(leaves, sc, bits=8, group_size=128,
                                  cols=(c0, n))
    want = sf.squant_flip_leaves_plain([x.cpu() for x in leaves],
                                       want_sc, bits=8, group_size=128,
                                       cols=(c0, n))
    assert codes.shape == (3, n, 512)
    assert (codes.cpu() != want).float().mean() < 1e-4   # float32-sum ties
    route = "cp16" if c0 % 4 == 0 and n % 4 == 0 else "cp4"
    assert sf.launches_by_route[route] == before[route] + 1


def _tree(dev, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {f"l{i}": {"w": torch.randn((512, 384), generator=gen,
                                       device=dev)} for i in range(3)} | {
        "moe": {"w": torch.randn((2, 256, 384), generator=gen, device=dev)}}


def _equal_trees(a, b):
    from repro_torch.distributed.sharding import gather_tree
    a, b = gather_tree(a), gather_tree(b)
    for k in b:
        assert torch.equal(a[k]["w"].data, b[k]["w"].data), k
        assert torch.equal(a[k]["w"].scale, b[k]["w"].scale), k


def test_one_rank_nccl_mesh(dev, tmp_path):
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.pipeline import quantize_tree
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.kernels import squant_flip as sf
    from repro_torch.launch.mesh import make_quantize_mesh
    from repro_torch.quant.apply import quantize_params_serving
    mesh = make_quantize_mesh()
    try:
        assert dist.get_backend() == "nccl"
        tree = _tree(dev)
        n0 = sf.launches
        q, rep = quantize_tree(tree, bits=8, mesh=mesh)
        assert sf.launches - n0 == len(rep.buckets)
        assert all(b.route == "native" for b in rep.buckets)
        _equal_trees(q, quantize_tree(tree, bits=8)[0])
        qd, meta = quantize_params_serving(tree, 8)
        ck = Checkpointer(str(tmp_path), async_save=False)
        ck.save_serving(1, qd, quant_meta=meta)
        placed, _, _ = ck.restore_serving(mesh=mesh)
        placed = gather_tree(placed)
        for k in qd:
            for kk in qd[k]:
                assert torch.equal(placed[k][kk], qd[k][kk])
    finally:
        group.shutdown()


_CHILD = '''
import torch
import torch.distributed as dist
from repro_torch.core.pipeline import quantize_tree
from repro_torch.distributed import group
from repro_torch.distributed.sharding import gather_tree
from repro_torch.launch.mesh import make_quantize_mesh
from repro_torch.training.grad_compression import BLOCK, ring_allreduce_i8

def main():
    dev = group.device()
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {f"l{i}": {"w": torch.randn((512, 384), generator=gen,
                                       device=dev)} for i in range(3)}
    tree["moe"] = {"w": torch.randn((2, 256, 300), generator=gen,
                                    device=dev)}
    q, rep = quantize_tree(tree, bits=8, mesh=make_quantize_mesh())
    q = gather_tree(q)
    p, _ = quantize_tree(tree, bits=8)
    same = all(torch.equal(q[k]["w"].data, p[k]["w"].data) and
               torch.equal(q[k]["w"].scale, p[k]["w"].scale) for k in p)
    x = torch.randn(2 * BLOCK * 4, generator=gen, device=dev) * (
        dist.get_rank() + 1)
    red = ring_allreduce_i8(x, None)
    return same, [r.route for r in rep.buckets], red.cpu(), x.cpu()
'''

_HOST = '''
import torch
import torch.distributed as dist
from repro_torch.training.grad_compression import ring_allreduce_i8

def main(xs):
    return ring_allreduce_i8(xs[dist.get_rank()], None)
'''


def test_two_gloo_ranks_share_the_card(dev, tmp_path):
    from repro_torch.distributed.group import run_local
    res = run_local(_CHILD, 2, backend="gloo", device="cuda", timeout=300,
                    store_dir=str(tmp_path))
    for same, routes, _, _ in res:
        assert same and set(routes) == {"native"}
    assert torch.equal(res[0][2], res[1][2])
    host = run_local(_HOST, 2, backend="gloo", device="cpu",
                     args=([r[3] for r in res],), timeout=300,
                     store_dir=str(tmp_path))
    assert torch.equal(host[0], res[0][2])
