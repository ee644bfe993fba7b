"""Elastic scaling: re-factorize the mesh for a changed rank count and
reshard the latest checkpoint onto it.

Policy: keep the model axis as close to the preferred TP degree as the
rank count allows (TP must divide the head/ffn dims), put the rest in
data (FSDP/DP), and add the pod axis only for multi-pod counts. Checkpoints
are shard-agnostic (see checkpoint/checkpointer.py), so a restore onto the
new mesh is just ``restore(..., shardings=make_param_shardings(new_mesh))``
(or a train step's ``sharding.make_fsdp_shardings(new_mesh, tree, cfg)``).
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.distributed import group


def choose_mesh_shape(n_devices: int, prefer_model: int = 16,
                      pod_size: Optional[int] = None
                      ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis_names) for an arbitrary device count."""
    if pod_size and n_devices > pod_size and n_devices % pod_size == 0:
        pods = n_devices // pod_size
        inner, names = choose_mesh_shape(pod_size, prefer_model)
        return (pods,) + inner, ("pod",) + names
    model = 1
    for cand in range(min(prefer_model, n_devices), 0, -1):
        if n_devices % cand == 0:
            model = cand
            break
    return (n_devices // model, model), ("data", "model")


def make_elastic_mesh(n_devices: Optional[int] = None,
                      prefer_model: int = 16, pod_size: Optional[int] = None,
                      *, backend=None, device=None):
    """The mesh :func:`choose_mesh_shape` gives for ``n_devices`` (default:
    every rank of the group)."""
    group.ensure_group(backend, device)
    n = n_devices or group.world_size()
    shape, names = choose_mesh_shape(n, prefer_model, pod_size)
    return group.make_mesh(shape, names, backend=backend, device=device)
