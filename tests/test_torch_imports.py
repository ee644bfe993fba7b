"""The port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the reference package, and importing the
whole package needs no GPU, no CUDA compiler and no ``triton``."""
import ast
import importlib
import os
import pkgutil

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_no_reference_package(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro", "flax", "triton"}, roots


def test_every_module_imports_without_cuda():
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert len(names) >= 30
    # the distributed layer is in the walk (and in _sources' files)
    assert {"repro_torch.distributed.group", "repro_torch.distributed.sharding",
            "repro_torch.launch.mesh", "repro_torch.runtime.elastic",
            "repro_torch.training.grad_compression"} <= set(names)
    for name in names:
        importlib.import_module(name)


def test_kernel_sources_present():
    from repro_torch.kernels import _build
    for name in _build.SOURCES:
        assert os.path.isfile(os.path.join(_build.CSRC, name + ".cu"))


def test_cuda_backend_refuses_cpu_tensor():
    import torch
    from repro_torch.kernels import ops
    w = torch.zeros(4, 32)
    s = torch.ones(4, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.squant_flip(w, s, bits=4, group_size=16, backend="cuda")
