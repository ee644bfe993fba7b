"""Port vs reference: ``runtime/elastic.choose_mesh_shape`` over a grid of
rank counts, preferred model degrees and pod sizes; the mesh factories of
``launch/mesh`` and ``runtime/elastic`` on a one-rank gloo group, which
raise where the group lacks the ranks, as the reference's do where the host
lacks the devices."""
import pytest

from repro.runtime.elastic import choose_mesh_shape as jax_choose
from repro_torch.distributed import group
from repro_torch.launch import mesh as tmesh
from repro_torch.runtime.elastic import choose_mesh_shape, make_elastic_mesh


@pytest.mark.parametrize("pod_size", [None, 4, 256])
def test_choose_mesh_shape_equals_reference(pod_size):
    for n in range(1, 601):
        for prefer in range(1, 17):
            assert choose_mesh_shape(n, prefer, pod_size) == \
                jax_choose(n, prefer, pod_size), (n, prefer, pod_size)


@pytest.fixture
def one_rank():
    yield
    group.shutdown()


def test_factories_on_one_rank(one_rank):
    mesh = make_elastic_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    assert tuple(mesh.get_coordinate()) == (0, 0)
    q = tmesh.make_quantize_mesh(device="cpu")
    assert q.mesh_dim_names == ("data",) and tuple(q.shape) == (1,)
    for fn in (lambda: tmesh.make_quantize_mesh(2),
               lambda: tmesh.make_debug_mesh(),
               lambda: tmesh.make_debug_mesh(multi_pod=True),
               lambda: tmesh.make_production_mesh(),
               lambda: tmesh.make_production_mesh(multi_pod=True),
               lambda: make_elastic_mesh(8)):
        with pytest.raises(ValueError):
            fn()
    with pytest.raises(ValueError, match="runs gloo"):
        group.make_mesh((1,), ("data",), backend="nccl")
