"""Process groups, device meshes and the collectives the port runs on them.

The reference builds one ``jax.sharding.Mesh`` over the devices of one
process. Here every rank is a process with one device (a card, or the
host), joined by ``torch.distributed``:

* :func:`init_group` brings up the default process group for one rank from
  a store: a ``FileStore`` on a path every rank shares (made under a
  temporary directory when none is given), or a store the caller made
  (``TCPStore`` on a port the caller chose). Nothing listens on a fixed
  port.
* :func:`make_mesh` is ``init_device_mesh`` over the first ``prod(shape)``
  ranks. With no group initialized it first makes a **one-rank group** of
  its own, as ``jax.make_mesh`` gives a one-device mesh with no launcher.
* :func:`run_local` starts ``world`` rank processes on this host with the
  ``spawn`` start method (never ``fork``: the parent may hold torch's
  threads, or a CUDA context), runs a function in each and returns what each
  returned.

The backend is an explicit choice, never a fallback:

* ``"nccl"`` for CUDA with one rank a card, the default for a CUDA device.
  NCCL refuses two ranks on one card ("Duplicate GPU detected"), so ranks
  that share a card run on gloo, and :func:`init_group` says so up front.
* ``"gloo"`` for CPU tensors, the default on the host, and for several
  ranks sharing one card.

Gloo moves host memory: on torch 2.11 a gloo ``send`` of a CUDA tensor fails
("writev ... Bad address") and takes the group's connections down with it.
So every collective below that is handed a CUDA tensor on a gloo group
(:func:`all_gather_into`, :func:`all_reduce`, :func:`reduce_scatter_into`,
:func:`ring_hop`, :func:`full_tensor`) stages it through a pinned host
buffer: a copy to the host, the collective there, a copy back. The copies
wait for the device, so on that path a collective is a host
synchronization; on NCCL it is not.
DTensor's own collectives do not stage, which is why :func:`full_tensor`
gathers a DTensor's shards itself instead of calling
``DTensor.full_tensor`` on a gloo group.

Tensor-parallel execution uses three autograd collectives over the 'model'
sub-group of a mesh (Megatron's f and g, and the logits' gather):
:func:`copy_to_model`, :func:`reduce_from_model` and
:func:`gather_from_model`; ``MODEL_COLLECTIVES`` counts them. MoE routing
under data parallelism (``sharding.RoutingGroup``) uses two over the
routing ranks, ``(E,)``-sized: :func:`routing_sum` (summed forward and
backward) and :func:`routing_gather`; ``ROUTING_COLLECTIVES`` counts them.
FSDP over 'data' uses one: :func:`gather_data` (an all-gather of a
period's shards forward, a float32 reduce-scatter of their gradients
backward, :func:`reduce_scatter_into`); ``DATA_COLLECTIVES`` counts its
calls, milliseconds and bytes by kind.
"""
from __future__ import annotations

import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

# the device this process's rank computes on, set by init_group
_DEVICE: Optional[torch.device] = None
_OWN_GROUP = False        # the one-rank group make_mesh made for itself
_OWN_STORE_DIR: Optional[str] = None   # the store directory init_group made


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the host."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _rank_device(device, rank: int) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    return device


def init_group(rank: int, world: int, *, backend: str, device,
               store=None, store_path: Optional[str] = None) -> torch.device:
    """Initialize the default process group for ``rank`` of ``world`` on
    ``backend``; returns the rank's device (``cuda`` → card ``rank %
    device_count``). ``store`` is a ``torch.distributed`` store; else a
    ``FileStore`` on ``store_path`` (every rank must pass the same path),
    else on a path in a new temporary directory (one rank only), which
    :func:`shutdown` removes."""
    global _DEVICE, _OWN_STORE_DIR
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options {BACKENDS}")
    device = _rank_device(device, rank)
    if device.type == "cuda":
        if backend == "nccl" and world > torch.cuda.device_count():
            raise ValueError(
                f"nccl takes one rank a card: {world} ranks on "
                f"{torch.cuda.device_count()} card(s); pass backend='gloo' "
                f"to share a card")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("nccl carries CUDA tensors only; use gloo on the "
                         "host")
    if store is None:
        if store_path is None:
            if world != 1:
                raise ValueError("ranks of a group must share a store: pass "
                                 "store or store_path")
            _OWN_STORE_DIR = tempfile.mkdtemp(prefix="repro_pg_")
            store_path = os.path.join(_OWN_STORE_DIR, "store")
        store = dist.FileStore(store_path, world)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, **kw)
    _DEVICE = device
    return device


def device() -> torch.device:
    """The device this rank computes on (set by :func:`init_group`)."""
    if _DEVICE is None:
        raise RuntimeError("no process group: call init_group or make_mesh")
    return _DEVICE


def ensure_group(backend: Optional[str] = None, device=None) -> None:
    """A one-rank default group where none is initialized (``device``
    default: the current CUDA device)."""
    global _OWN_GROUP
    if dist.is_initialized():
        return
    device = torch.device("cuda" if device is None else device)
    init_group(0, 1, backend=backend or default_backend(device),
               device=device)
    _OWN_GROUP = True


def shutdown(own_only: bool = False) -> None:
    """Destroy the default group (and forget the rank's device);
    ``own_only``: only a one-rank group :func:`ensure_group` made. The
    store directory :func:`init_group` made, if any, is removed."""
    global _DEVICE, _OWN_GROUP, _OWN_STORE_DIR
    if own_only and not _OWN_GROUP:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    if _OWN_STORE_DIR is not None:
        shutil.rmtree(_OWN_STORE_DIR, ignore_errors=True)
    _DEVICE, _OWN_GROUP, _OWN_STORE_DIR = None, False, None


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(shape: Sequence[int], names: Sequence[str], *,
              backend: Optional[str] = None, device=None):
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over ranks
    ``0 .. prod(shape) - 1`` (row-major, the last axis fastest, as a JAX
    mesh lays out its devices). Every rank of the group must call it; a
    rank outside the mesh gets one whose ``get_coordinate()`` is None.
    Raises ``ValueError`` where the world has fewer ranks than the mesh.
    With no group initialized, makes a one-rank group first on
    ``backend`` (default: :func:`default_backend` of ``device``)."""
    from torch.distributed.device_mesh import DeviceMesh
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if len(shape) != len(names) or len(set(names)) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} must "
                         f"pair up, names distinct")
    ensure_group(backend, device)
    n, world = math.prod(shape), dist.get_world_size()
    if not 1 <= n <= world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the group has "
                         f"{world}")
    if backend is not None and dist.get_backend() != backend:
        raise ValueError(f"the group runs {dist.get_backend()}, not "
                         f"{backend}")
    mesh = DeviceMesh(_DEVICE.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)
    mesh_group(mesh)       # new_group is collective over the whole world
    return mesh


# ---------------------------------------------------------------------------
# collectives (staged through the host on a gloo group; see the docstring)
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``t`` (waits for the device)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_gather_into(out: torch.Tensor, t: torch.Tensor, group=None
                    ) -> torch.Tensor:
    """``out`` (the group's ``t`` concatenated along dim 0, in group-rank
    order) via ``all_gather_into_tensor``."""
    if _staged(t, group):
        h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.all_gather_into_tensor(h, _host(t), group=group)
        out.copy_(h, non_blocking=True)
    else:
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
    return out


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group, in place."""
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h, non_blocking=True)
    else:
        dist.all_reduce(t, group=group)
    return t


def reduce_scatter_into(out: torch.Tensor, t: torch.Tensor, group=None
                        ) -> torch.Tensor:
    """``out``: this rank's part of ``t`` summed over the group, where
    ``t`` is the group's size of equal parts along dim 0 in group-rank
    order (``reduce_scatter_tensor``)."""
    if _staged(t, group):
        h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(h, _host(t), group=group)
        out.copy_(h, non_blocking=True)
    else:
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def reduce_scatter_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's part of ``t`` summed over the group, ``t`` cut into the
    group's size of equal parts along ``dim`` in group-rank order (the
    inverse of :func:`gather_dim`'s layout; no copy of a contiguous ``t``
    cut on dim 0)."""
    n = dist.get_world_size(group)
    dim = dim % t.ndim
    parts = t.unflatten(dim, (n, -1)).movedim(dim, 0).contiguous()
    out = torch.empty(parts.shape[1:], dtype=t.dtype, device=t.device)
    reduce_scatter_into(out.view(-1), parts.view(-1), group)
    return out


def ring_hop(send: Sequence[torch.Tensor], recv: Sequence[torch.Tensor],
             group) -> None:
    """One ring hop over ``group``: every rank sends ``send`` to the next
    group rank and receives ``recv`` from the previous one (the reference's
    ``lax.ppermute`` with ``perm = [(i, i + 1 mod R)]``)."""
    group = group or dist.group.WORLD
    r = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % r)
    prv = dist.get_global_rank(group, (me - 1) % r)
    staged = _staged(send[0], group)
    snd = [_host(s) for s in send] if staged else list(send)
    rcv = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
           for t in recv] if staged else list(recv)
    ops = [dist.P2POp(dist.isend, s, nxt, group) for s in snd] + \
          [dist.P2POp(dist.irecv, t, prv, group) for t in rcv]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    if staged:
        for t, h in zip(recv, rcv):
            t.copy_(h, non_blocking=True)


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``t`` concatenated along ``dim`` in group-rank order
    (on dim 0, a view of the gathered buffer: no copy)."""
    n = dist.get_world_size(group)
    dim = dim % t.ndim
    parts = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                        device=t.device)
    all_gather_into(parts.view(-1), t.contiguous().view(-1), group)
    if dim == 0:
        return parts.view((-1,) + tuple(t.shape[1:]))
    return torch.cat(parts.unbind(0), dim=dim)


# the tensor-parallel collectives over 'model' (see distributed.sharding):
# calls and host milliseconds, forward and backward together. A collective
# staged on gloo first synchronizes the device, outside the timed span, so
# its time is the copies and the collective, not the kernels queued before
# it; on NCCL it is the launch's
MODEL_COLLECTIVES = {"calls": 0, "ms": 0.0}
# the MoE routing collectives over a data-parallel routing group, the same
ROUTING_COLLECTIVES = {"calls": 0, "ms": 0.0}
# FSDP's collectives over 'data' (gather_data), the same, by kind: a
# gather's bytes are the gathered buffer's, a reduce-scatter's its float32
# input's (the group's size times this rank's part)
DATA_COLLECTIVES = {"gather": {"calls": 0, "ms": 0.0, "bytes": 0},
                    "reduce_scatter": {"calls": 0, "ms": 0.0, "bytes": 0}}


def _counted(fn, t: torch.Tensor, *args, counter=MODEL_COLLECTIVES,
             nbytes: int = 0):
    """``fn(t, *args)``, a collective over the group ``args[-1]`` (or the
    groups of a tuple there), counted and timed in ``counter`` (and its
    ``nbytes`` added where the counter keeps bytes)."""
    groups = args[-1] if isinstance(args[-1], tuple) else (args[-1],)
    if any(_staged(t, g) for g in groups):
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    out = fn(t, *args)
    counter["calls"] += 1
    counter["ms"] += (time.perf_counter() - t0) * 1e3
    if "bytes" in counter:
        counter["bytes"] += nbytes
    return out


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: ``t`` summed over the group, a bfloat16 ``t`` in
    float32 (each rank's partial sum rounded once, the total once)."""
    acc = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    return all_reduce(acc, group).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _counted(_sum, g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _counted(_sum, x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[-1]
        return _counted(gather_dim, x, -1, group)

    @staticmethod
    def backward(ctx, g):
        k = dist.get_rank(ctx.group)
        return g[..., k * ctx.n:(k + 1) * ctx.n].contiguous(), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over ``group`` backward."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` forward; identity backward."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` gathered along its last dim over ``group`` forward; this
    rank's slice of the gradient backward."""
    return _GatherFromModel.apply(x, group)


def _sum_over(t: torch.Tensor, groups: Tuple) -> torch.Tensor:
    """A new float32 tensor: ``t`` summed over each of ``groups`` in turn
    (together the routing ranks)."""
    acc = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    for g in groups:
        all_reduce(acc, g)
    return acc


class _RoutingSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _counted(_sum_over, x, groups, counter=ROUTING_COLLECTIVES)

    @staticmethod
    def backward(ctx, g):
        return _counted(_sum_over, g, ctx.groups,
                        counter=ROUTING_COLLECTIVES), None


def routing_sum(x: torch.Tensor, routing) -> torch.Tensor:
    """``x`` summed over the ranks of ``routing`` (a
    ``sharding.RoutingGroup``) in float32, forward and backward: each
    rank's loss carries the sum, so the gradient of each rank's own terms
    is the sum of every rank's (the step then averages over the ranks). An
    all-reduce with an identity backward would leave each rank's terms
    1/R of their gradient."""
    return _RoutingSum.apply(x, tuple(routing.groups))


def _gather_over(t: torch.Tensor, groups: Tuple) -> torch.Tensor:
    out = t
    for g in reversed(groups):                   # minor axis first
        out = gather_dim(out.unsqueeze(0), 0, g)
    return out.reshape((-1,) + tuple(t.shape))


def routing_gather(t: torch.Tensor, routing) -> torch.Tensor:
    """Every routing rank's ``t`` stacked in ``routing.index`` order (no
    gradient)."""
    return _counted(_gather_over, t.detach(), tuple(routing.groups),
                    counter=ROUTING_COLLECTIVES)


def _pad16(n: int) -> int:
    return -n % 16


class _GatherData(torch.autograd.Function):
    """FSDP's gather of a group of shards over 'data': their bytes in one
    all-gather forward (each shard's segment padded to 16 bytes, so every
    dtype's view is aligned), the gradients' float32 sums back to each
    rank's shards in one reduce-scatter backward."""

    @staticmethod
    def forward(ctx, group, dims, *shards):
        n = dist.get_world_size(group)
        ctx.group, ctx.n, ctx.dims = group, n, dims
        ctx.meta = [(s.shape, s.dtype) for s in shards]
        segs = []
        for s in shards:
            b = s.detach().contiguous().view(-1).view(torch.uint8)
            segs += [b, b.new_zeros(_pad16(b.numel()))]
        flat = torch.cat(segs).unsqueeze(0)
        parts = _counted(gather_dim, flat, 0, group,      # (n, bytes)
                         counter=DATA_COLLECTIVES["gather"],
                         nbytes=n * flat.numel())
        out, off = [], 0
        for s, d in zip(shards, dims):
            nb = s.numel() * s.element_size()
            out.append(torch.cat([parts[i, off:off + nb].view(s.dtype)
                                  .view(s.shape) for i in range(n)], dim=d))
            off += nb + _pad16(nb)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        n = ctx.n
        rows = torch.cat([torch.stack([c.reshape(-1) for c in
                                       g.to(torch.float32).chunk(n, dim=d)])
                          for g, d in zip(grads, ctx.dims)], dim=1)
        mine = _counted(reduce_scatter_dim, rows, 0, ctx.group,
                        counter=DATA_COLLECTIVES["reduce_scatter"],
                        nbytes=rows.numel() * rows.element_size()).view(-1)
        out, off = [], 0
        for shape, dtype in ctx.meta:
            k = math.prod(shape)
            out.append(mine[off:off + k].view(shape).to(dtype))
            off += k
        return (None, None) + tuple(out)


def gather_data(shards: Sequence[torch.Tensor], dims: Sequence[int], group
                ) -> List[torch.Tensor]:
    """FSDP's gather over 'data' (``group``): each of
    ``shards`` concatenated along its dim of ``dims`` over the group, in
    group-rank order, in one all-gather; backward, each gradient summed
    over the group in float32 and cut back to this rank's shard, in one
    reduce-scatter. ``DATA_COLLECTIVES`` counts both."""
    return list(_GatherData.apply(group, tuple(dims), *shards))


def full_tensor(x):
    """The whole tensor of a DTensor on every rank (a plain tensor is
    returned as it is). On NCCL, or on the host, this is
    ``DTensor.full_tensor``; for CUDA shards on a gloo group, and for a
    strided shard (``sharding.MeshSharding.split``: its layout is read by
    the port's own ``shard_index``, not left to the torch version's), the
    shards are gathered (through the host on gloo) and put in place here
    (even shards only: the sharding rules shard a dim only where the mesh
    axes divide it)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import placement_split, shard_index
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    local = x.to_local()
    if placement_split(x) == 1 and (not local.is_cuda
                                    or dist.get_backend() != "gloo"):
        return x.full_tensor()
    sizes = tuple(mesh.mesh.shape)
    n = mesh.mesh.numel()
    parts = torch.empty((n,) + tuple(local.shape), dtype=local.dtype,
                        device=local.device)
    all_gather_into(parts.view(-1), local.contiguous().view(-1),
                    mesh_group(mesh))
    out = torch.empty(tuple(x.shape), dtype=local.dtype, device=local.device)
    for i in range(n):
        out[shard_index(x.shape, x.placements, sizes, _unravel(i, sizes))] \
            = parts[i]
    return out


def _unravel(i: int, sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(sizes):
        out.append(i % s)
        i //= s
    return tuple(reversed(out))


_MESH_GROUPS: dict = {}


def mesh_group(mesh):
    """One process group over all of ``mesh``'s ranks, in mesh order (None,
    the whole default group, where the mesh covers it)."""
    ranks = tuple(mesh.mesh.flatten().tolist())
    if ranks == tuple(range(dist.get_world_size())):
        return None
    if ranks not in _MESH_GROUPS:
        _MESH_GROUPS[ranks] = dist.new_group(list(ranks))
    return _MESH_GROUPS[ranks]


# ---------------------------------------------------------------------------
# the local launcher
# ---------------------------------------------------------------------------

def _child(fn, rank, world, backend, device, store_path, out_dir, args):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    res_path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        init_group(rank, world, backend=backend, device=device,
                   store_path=store_path)
        if isinstance(fn, str):                  # a script defining main()
            ns = {"__name__": "__run_local__"}
            exec(compile(fn, "<run_local script>", "exec"), ns)
            fn = ns["main"]
        result = ("ok", fn(*args))
    except BaseException:                        # reported by the parent
        result = ("error", traceback.format_exc())
    with open(res_path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(res_path + ".tmp", res_path)
    try:
        shutdown()
    except Exception:
        pass


def run_local(fn, world: int, *, backend: str, device,
              args: Tuple = (), timeout: float = 600.0,
              store_dir: Optional[str] = None) -> List[Any]:
    """Run ``fn(*args)`` in ``world`` rank processes of one new group and
    return each rank's result, rank 0 first.

    ``fn`` is a function the children can import by name (a module-level
    function of a module on the path), or the source of a script that
    defines ``main(*args)``. Each child initializes its group (a
    ``FileStore`` in a new directory under ``store_dir``, default the
    system's temporary directory, removed on return) on
    ``backend`` and ``device`` (``"cuda"``: card ``rank % device_count``)
    before it calls ``fn``. Results travel back pickled, so return host
    objects (numpy arrays, numbers). Raises ``RuntimeError`` with the
    child's traceback if a rank fails, and kills every rank still running
    after ``timeout`` seconds."""
    import multiprocessing as mp
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options {BACKENDS}")
    work = tempfile.mkdtemp(prefix="repro_run_local_", dir=store_dir)
    store_path = os.path.join(work, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(fn, r, world, backend, device,
                                              store_path, work, tuple(args)),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results, errors = [], []
    try:
        for r, p in enumerate(procs):
            path = os.path.join(work, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r} exited {p.exitcode} with no result"
                              + (" (timed out)" if r in late else ""))
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} failed:\n{value}")
            results.append(value)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if errors:
        raise RuntimeError("run_local: " + "\n".join(errors))
    return results
