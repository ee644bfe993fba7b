"""Production mesh factories.

Functions, not module-level constants — importing this module touches no
process group. Each builds a ``DeviceMesh`` over the first ranks of the
default group (``distributed.group.make_mesh``; with no group initialized,
a one-rank group of its own) and raises ``ValueError`` where the group has
fewer ranks than the mesh needs. Every rank of the group calls the factory.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed import group


def make_production_mesh(*, multi_pod: bool = False, backend=None,
                         device=None):
    """The assigned production mesh: 16×16 per pod, 2 pods multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return group.make_mesh(shape, axes, backend=backend, device=device)


def make_debug_mesh(*, multi_pod: bool = False, backend=None, device=None):
    """Scaled-down mesh (8 ranks) with the production topology."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return group.make_mesh(shape, axes, backend=backend, device=device)


def make_quantize_mesh(n_devices: Optional[int] = None, *, backend=None,
                       device=None):
    """1-axis 'data' mesh for sharded quantization (``quantize_tree(mesh=)``).

    SQuant's flip objective is row-independent, so quantization parallelism
    is pure row DP: one flat 'data' axis over every rank of the group (or
    the first ``n_devices`` of them).
    """
    group.ensure_group(backend, device)
    world = group.world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, the group has {world} "
                         f"ranks")
    return group.make_mesh((n,), ("data",), backend=backend, device=device)
