"""Train step builder + fault-tolerant training loop.

``make_train_step`` supports:
* microbatch gradient accumulation (sequential slices of the batch,
  gradients summed in float32);
* data parallelism over a mesh (``mesh=``): every rank is handed the
  global batch, takes its slice over the ('pod', 'data') axes, and the
  gradients are averaged over those ranks in float32 (up to the order of
  the gradient sum, the reference's numbers, whichever layout holds the
  parameters). A rank's microbatch i is its slice of the reference's
  microbatch i (global rows ``[i·n/M, (i+1)·n/M)``), and an MoE layer
  routes the tokens the reference routes together
  (``sharding.RoutingGroup``: the global batch, a pod's batch under
  ``pod_compress``), not each rank's alone;
* the int8 cross-pod gradient all-reduce with error feedback
  (``pod_compress=True`` on a mesh with a 'pod' axis of 2 or more): float32
  in-pod reduction over 'data', then ``grad_compression``'s int8 ring over
  'pod';
* tensor parallelism over 'model' (a mesh whose 'model' axis is larger
  than 1), Megatron-style for the dense GQA transformer and the
  encoder-decoder (whose ``enc_frames`` batches split over 'data' as the
  tokens do) and expert-parallel for MoE (every expert's FFN columns
  where 'model' does not divide the experts, the reference's
  'expert_ff' fallback): the parameters and AdamW moments are DTensors
  of ``distributed.sharding.tp_place``'s layout, each rank computes on its
  shards (an MoE rank on its experts), and the collectives run where the
  reference annotates its activations; it composes with the data
  parallelism and the pod compression above. Heads and FFN widths 'model'
  does not divide are held whole on every rank (``tp_place``'s
  ``Replicate``) and narrowed to each rank's replica-group
  shard in the forward, so their gradients come back whole like any
  replicated leaf's. The cases ``sharding.check_tensor_parallel`` names
  raise ``NotImplementedError``;
* FSDP (ZeRO-3) over 'data', at any 'model' size (1 included): the
  parameters and AdamW moments are DTensors of
  ``distributed.sharding.fsdp_place``'s layout (or of the rules' own,
  ``reshard_serving_tree``, for the dense model), each rank holds and
  updates its shards, the forward gathers a period's shards over 'data'
  where it starts (``sharding.gather_params``) and their gradients come
  back reduce-scattered. The replicated layout (``tp_place``, or plain
  tensors where 'model' is 1) keeps a whole replica a data rank.

``Trainer`` owns the loop: checkpoint every N steps, restart from the newest
checkpoint, preemption handling (SIGTERM → checkpoint + clean exit) and a
straggler monitor.
"""
from __future__ import annotations

import dataclasses
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.transformer import n_periods
from repro_torch.training.grad_compression import (compress_local,
                                                   ring_allreduce_i8,
                                                   ring_pad, unflatten_grads)
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, decay_mask,
                                            global_norm, tree_leaves,
                                            tree_map)

def _value_and_grad(loss_fn, params, batch):
    """``(loss, metrics, grads)`` of ``loss_fn(params, batch)``: gradients
    with respect to every leaf of ``params`` (zeros for a leaf the loss does
    not use), in each leaf's dtype; loss and metrics detached."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(live, batch)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gs)}
    grads = tree_map(lambda p: by_leaf[id(p)], live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _accumulate_grads(loss_fn, params, batch, microbatches: int):
    """Mean loss and grads over ``microbatches`` sequential slices of the
    batch (grads summed in float32, then divided); the metrics are the last
    microbatch's."""
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)
    n = next(iter(batch.values())).shape[0]
    if n % microbatches:
        raise ValueError(f"batch {n} is not divisible into {microbatches} "
                         f"microbatches")
    per = n // microbatches
    gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
    lsum = None
    for i in range(microbatches):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        loss, metrics, g = _value_and_grad(loss_fn, params, mb)
        gsum = tree_map(lambda a, b: a + b.to(torch.float32), gsum, g)
        del g
        lsum = loss if lsum is None else lsum + loss
    grads = tree_map(lambda g: g / microbatches, gsum)
    return lsum / microbatches, metrics, grads


def make_train_step(model, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    pod_compress: bool = False, mesh=None,
                    grad_reduce_dtype: Optional[torch.dtype] = None
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``: ``batch`` holds tensors on the parameters' device, metrics
    ``loss``, ``xent``, ``moe_aux``, ``lr`` and ``grad_norm`` as 0-d
    tensors there (nothing is read back to the host).

    Weight decay falls on the leaves the reference decays for the same
    config: with ``scan_layers`` and more than one period its stack is
    stacked and decays the norm gains too (:func:`decay_mask`).

    ``grad_reduce_dtype`` casts the accumulated gradients before the
    update (the reference's wire-bytes option; the moments stay
    float32).

    ``mesh`` (a ``DeviceMesh``; every rank of it runs the step on the same
    global batch): the step is data-parallel over the mesh's 'pod' and
    'data' axes, each data rank holding a replica of the parameters or,
    placed by ``distributed.sharding.fsdp_place``, its FSDP shards. With
    ``pod_compress`` and a 'pod' axis of 2 or more it returns
    ``train_step(params, opt_state, err, batch) → (params, opt_state,
    err, metrics)``: pod-local float32 gradients (all-reduced over
    'data'), ``compress_local`` with the pod's error-feedback row of
    ``err`` (:func:`init_pod_error`), the int8 ring over 'pod', ``/
    n_pods``, then AdamW; the metrics are averaged over the ranks. Without
    a 'pod' axis of 2 or more ``pod_compress`` is ignored, as in the
    reference. A 'model' axis above 1 makes the step tensor-parallel
    (:func:`_parallel_step`): ``params`` and ``opt_state``'s moments are
    then DTensor trees of ``distributed.sharding.tp_place``'s or
    ``fsdp_place``'s layout on ``mesh``, and come back so. Set
    ``step.timed = True`` on a mesh's step to have each call leave its
    split in ``step.split_ms`` (grads, the all-reduces, the FSDP gathers
    and reduce-scatters, compress and ring where it compresses, update),
    measured between synchronizations of the device. A mesh's step without
    compression also has ``step.averaged_grads(params, batch)``: the loss,
    metrics (with the global ``grad_norm``) and gradients it would update
    with.
    """
    sizes = {}
    if mesh is not None:
        from repro_torch.distributed.sharding import (check_tensor_parallel,
                                                      mesh_axis_sizes)
        sizes = mesh_axis_sizes(mesh)
        check_tensor_parallel(model.cfg, mesh)

    def loss_fn(p, b):
        return model.train_loss(p, b)

    stacked = model.cfg.scan_layers and n_periods(model.cfg) > 1

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _grads(loss_fn, params, batch, microbatches,
                                      grad_reduce_dtype)
        return _update(params, opt_state, grads, loss, metrics, opt_cfg,
                       stacked)

    compress = pod_compress and sizes.get("pod", 1) >= 2
    if all(sizes.get(a, 1) == 1 for a in ("pod", "data", "model")):
        return train_step
    return _parallel_step(model, opt_cfg, mesh, sizes, loss_fn, stacked,
                          microbatches, grad_reduce_dtype, compress)


def _local_batch(batch, outer: int, inner: int, o: int, i: int,
                 microbatches: int):
    """A data-parallel rank's rows of the global batch: the batch is
    ``outer`` contiguous parts routed apart (pods under ``pod_compress``,
    else one), each of ``microbatches`` contiguous microbatches, each
    split over the ``inner`` ranks that route it together; the rank at
    ``(o, i)`` gets its slice of each of part ``o``'s microbatches, in
    order, so ``_accumulate_grads``'s sequential microbatches are those
    slices."""
    n = next(iter(batch.values())).shape[0]
    if n % (outer * inner * microbatches):
        raise ValueError(f"global batch {n} is not divisible over "
                         f"{outer * inner} data-parallel ranks and "
                         f"{microbatches} microbatches")
    per = n // (outer * inner * microbatches)

    def mine(v):
        v = v.reshape((outer, microbatches, inner, per) + tuple(v.shape[1:]))
        return v[o, :, i].reshape((microbatches * per,) + tuple(v.shape[4:]))
    return {k: mine(v) for k, v in batch.items()}


def _grads(loss_fn, params, batch, microbatches, grad_reduce_dtype):
    loss, metrics, grads = _accumulate_grads(loss_fn, params, batch,
                                             microbatches)
    if grad_reduce_dtype is not None:
        grads = tree_map(lambda g: g.to(grad_reduce_dtype), grads)
    return loss, metrics, grads


def _reduce_mean(grads, groups, n: int, fsdp=None, fsdp_groups=()):
    """The tree's mean over ``n`` ranks, in float32: one all-reduce of the
    flattened tree over each of ``groups`` in turn (together the ranks).
    The leaves where ``fsdp`` (a tree of bools) is True are FSDP shards
    whose gradients the reduce-scatter already summed over 'data': they
    are all-reduced over ``fsdp_groups`` only (the 'pod' ranks), in one
    all-reduce of their own."""
    from repro_torch.distributed import group as dgroup
    leaves = tree_leaves(grads)
    sharded = [False] * len(leaves) if fsdp is None else tree_leaves(fsdp)
    by_leaf = {}
    for mine, gs in ((False, groups), (True, fsdp_groups)):
        part = [x for x, f in zip(leaves, sharded) if f == mine]
        if not part:
            continue
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x in part])
        for g in gs:
            dgroup.all_reduce(flat, g)
        flat = flat / n
        off = 0
        for x in part:
            by_leaf[id(x)] = flat[off:off + x.numel()].reshape(x.shape) \
                .to(x.dtype)
            off += x.numel()
    return tree_map(lambda x: by_leaf[id(x)], grads)


def _mean_metrics(loss, metrics, groups, n: int):
    """Loss and metrics averaged over ``n`` ranks (summed over each of
    ``groups`` in turn)."""
    from repro_torch.distributed import group as dgroup
    vals = [loss] + [metrics[k] for k in sorted(metrics)]
    flat = torch.stack([v.to(torch.float32).reshape(()) for v in vals])
    for g in groups:
        dgroup.all_reduce(flat, g)
    flat = flat / n
    return flat[0], {k: flat[i + 1] for i, k in enumerate(sorted(metrics))}


def _update(params, opt_state, grads, loss, metrics, opt_cfg, stacked,
            grad_norm=None):
    params, opt_state, info = adamw_update(
        params, grads, opt_state, opt_cfg, decay_mask(params, stacked),
        grad_norm=grad_norm)
    metrics = dict(metrics)
    metrics.update(info)
    metrics["loss"] = loss
    return params, opt_state, metrics


class _Timer:
    """Host-clock split of a step between device synchronizations (only
    while ``on``). The tensor-parallel collectives of the forward and
    backward (``group.MODEL_COLLECTIVES``) are taken out of "grads" into
    "model_all_reduce" where 'model' is above 1, and FSDP's
    (``group.DATA_COLLECTIVES``) into "data_gather" and "reduce_scatter"
    where the step gathers over 'data'."""

    def __init__(self, on: bool, tp: int, fsdp: bool = False):
        from repro_torch.distributed import group as dgroup
        self.on, self.tp, self.fsdp, self.ms = on, tp, fsdp, {}
        self.device = dgroup.device() if on else None
        self._coll = dgroup.MODEL_COLLECTIVES
        self._data = dgroup.DATA_COLLECTIVES
        self._c0 = self._coll["ms"]
        self._d0 = {k: c["ms"] for k, c in self._data.items()}
        self._t = time.perf_counter() if on else 0.0

    def mark(self, name: str) -> None:
        if not self.on:
            return
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        t = time.perf_counter()
        self.ms[name] = self.ms.get(name, 0.0) + (t - self._t) * 1e3
        self._t = t

    def split(self) -> Dict[str, float]:
        if self.on and self.tp > 1:
            model_ms = self._coll["ms"] - self._c0
            self.ms["model_all_reduce"] = model_ms
            self.ms["grads"] -= model_ms
        if self.on and self.fsdp:
            for name, key in (("data_gather", "gather"),
                              ("reduce_scatter", "reduce_scatter")):
                ms = self._data[key]["ms"] - self._d0[key]
                self.ms[name] = ms
                self.ms["grads"] -= ms
        return self.ms


def _parallel_step(model, opt_cfg, mesh, sizes, loss_fn, stacked,
                   microbatches, grad_reduce_dtype, compress):
    """The step over ``mesh`` (see :func:`make_train_step`): every rank
    takes its slice of the global batch over the 'pod' and 'data' axes and
    runs the forward and backward under the mesh
    (``sharding.activate_mesh``). Where 'model' is above 1 it computes on
    its shards, Megatron-style, and the collectives run where the
    reference annotates its activations. The gradients, each rank's
    shard's, are averaged over the 'data' (and 'pod') ranks that share its
    'model' coordinate. A replicated leaf's gradient is already whole and
    equal on every 'model' rank (copy-to-model's backward sums it).

    A leaf placed with a shard over 'data' (FSDP, ``sharding.fsdp_place``)
    enters the forward as this rank's shard, listed in the step's
    ``sharding.FsdpPlan``: the forward gathers it over 'data' where it is
    used and its gradient comes back reduce-scattered, already summed over
    'data', so the averaging divides it by the data-parallel world and
    all-reduces it over 'pod' only. The global norm sums each leaf's
    squares over the axes that cut it: 'model' and 'data', 'data' alone,
    'model' alone, or none (a whole leaf, counted once).

    With ``compress`` the cross-pod leg is the int8 ring on the logical
    gradients, as the reference's ``compress_local`` flattens them: the
    in-pod float32 reduction over 'data', each leaf's gradient gathered
    over 'data' and 'model', compressed with the pod's logical
    error-feedback row (:func:`init_pod_error`'s shapes), the ring over
    'pod', ``/ n_pods``, then this rank's slice taken back.
    ``step.timed = True`` leaves each call's split in ``step.split_ms``."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.distributed import group as dgroup
    from repro_torch.distributed.sharding import (FsdpPlan, RoutingGroup,
                                                  activate_fsdp,
                                                  activate_mesh,
                                                  activate_routing,
                                                  data_shard, model_shard,
                                                  shard_index, unstride)
    n_pods, n_data, tp = (sizes.get(a, 1) for a in ("pod", "data", "model"))
    if tp > 1 and not isinstance(mesh, DeviceMesh):
        raise ValueError("a tensor-parallel step runs on a DeviceMesh of "
                         "the group's ranks")
    world = n_pods * n_data
    pod = mesh.get_local_rank("pod") if "pod" in sizes else 0
    dat = mesh.get_local_rank("data") if "data" in sizes else 0
    part = pod * n_data + dat           # this rank's slice of the batch
    data_group = mesh.get_group("data") if n_data > 1 else None
    pod_group = mesh.get_group("pod") if n_pods > 1 else None
    model_group = mesh.get_group("model") if tp > 1 else None
    # the data-parallel ranks: the whole mesh where 'model' is 1, else the
    # 'data', then the 'pod' ranks of this rank's 'model' coordinate
    dp_groups = [dgroup.mesh_group(mesh)] if tp == 1 else \
        [g for g in (data_group, pod_group) if g is not None]
    # the ranks whose tokens route together (an MoE layer's), and the batch
    # as parts routed apart x microbatches x those ranks: under
    # pod_compress each pod routes its own batch (the reference's
    # shard_map over 'pod'), else the whole batch routes together (GSPMD)
    axes = ((data_group, n_data),) if compress else \
        ((pod_group, n_pods), (data_group, n_data))
    axes = tuple((g, n) for g, n in axes if n > 1)
    routing = RoutingGroup(tuple(g for g, _ in axes),
                           tuple(n for _, n in axes),
                           dat if compress else part)
    rows = (n_pods, n_data, pod, dat) if compress else (1, world, 0, part)

    def unplace(tree):
        """This rank's plain tensors: a DTensor's local shard (over 'model'
        and, FSDP, 'data'), a plain tensor (a data-parallel replica) as it
        is."""
        def one(t):
            if not isinstance(t, DTensor):
                if tp > 1:
                    raise ValueError("the tensor-parallel step takes trees "
                                     "placed on its mesh by "
                                     "sharding.tp_place or fsdp_place")
                return t
            if t.device_mesh != mesh:
                raise ValueError("a DTensor placed on another mesh")
            if any(isinstance(p, Shard) for name, p in
                   zip(mesh.mesh_dim_names, t.placements)
                   if name not in ("model", "data")):
                raise ValueError("a DTensor sharded over an axis other "
                                 "than 'data' and 'model'")
            return t.to_local()
        return tree_map(one, tree)

    def replace(local, like):
        """``local`` placed as ``like``'s DTensor leaves are."""
        return tree_map(lambda x, t: DTensor.from_local(
            x, mesh, t.placements, run_check=False, shape=t.shape,
            stride=t.stride()) if isinstance(t, DTensor) else x, local, like)

    def shard_of(t) -> Optional[Tuple[int, int]]:
        """``(dim, split)`` of a DTensor's 'model' shard (None: whole)."""
        return model_shard(t) if isinstance(t, DTensor) else None

    def fsdp_dim(t) -> Optional[int]:
        """The dim a leaf's 'data' shard cuts (None: whole over 'data';
        a 'data' axis of 1 cuts nothing)."""
        return data_shard(t) if n_data > 1 and isinstance(t, DTensor) \
            else None

    def grads_of(local, like, batch, timer):
        dims = [fsdp_dim(t) for t in tree_leaves(like)]

        def fsdp_loss(p, b):
            plan = None
            if any(d is not None for d in dims):
                plan = FsdpPlan(data_group, {
                    id(x): d for x, d in zip(tree_leaves(p), dims)
                    if d is not None})
            with activate_fsdp(plan):
                return loss_fn(p, b)
        with activate_mesh(mesh), activate_routing(routing):
            out = _grads(fsdp_loss, local,
                         _local_batch(batch, *rows, microbatches),
                         microbatches, grad_reduce_dtype)
        timer.mark("grads")
        return out

    def is_fsdp(like) -> bool:
        return any(fsdp_dim(t) is not None for t in tree_leaves(like))

    def reduce_mean(grads, like, groups, n, fsdp_groups):
        return _reduce_mean(grads, groups, n,
                            tree_map(lambda t: fsdp_dim(t) is not None,
                                     like), fsdp_groups)

    def tp_norm(grads, like):
        """The logical tree's global norm from this rank's shards (None
        where nothing is sharded: ``adamw_update`` takes the tree's own).
        Squares of leaves cut by 'model' and 'data', by 'data' alone and
        by 'model' alone are summed over the axes that cut them."""
        if tp == 1 and not is_fsdp(like):
            return None
        sq = torch.zeros(4, dtype=torch.float32,
                         device=tree_leaves(grads)[0].device)
        for g, t in zip(tree_leaves(grads), tree_leaves(like)):
            k = 2 * (tp > 1 and shard_of(t) is not None) + \
                (fsdp_dim(t) is not None)
            sq[k] += torch.sum(torch.square(g.to(torch.float32)))
        over_data = torch.stack([sq[3], sq[1]])      # model+data, data
        if n_data > 1:
            dgroup.all_reduce(over_data, data_group)
        over_model = torch.stack([over_data[0], sq[2]])  # ..., model
        if tp > 1:
            dgroup.all_reduce(over_model, model_group)
        return torch.sqrt(over_model.sum() + over_data[1] + sq[0])

    def update(params, opt_state, local, grads, loss, metrics, gnorm):
        """AdamW on the local trees, placed back as ``params`` and
        ``opt_state`` are."""
        state = {"m": unplace(opt_state["m"]), "v": unplace(opt_state["v"]),
                 "step": opt_state["step"]}
        new, opt, metrics = _update(local, state, grads, loss, metrics,
                                    opt_cfg, stacked, grad_norm=gnorm)
        opt = {"m": replace(opt["m"], opt_state["m"]),
               "v": replace(opt["v"], opt_state["v"]), "step": opt["step"]}
        return replace(new, params), opt, metrics

    if not compress:
        def averaged(params, batch, timer):
            local = unplace(params)
            loss, metrics, grads = grads_of(local, params, batch, timer)
            if world > 1:
                grads = reduce_mean(grads, params, dp_groups, world,
                                    [pod_group] if n_pods > 1 else [])
                loss, metrics = _mean_metrics(loss, metrics, dp_groups,
                                              world)
            timer.mark("data_all_reduce")
            return local, loss, metrics, grads

        def step(params, opt_state, batch):
            timer = _Timer(step.timed, tp, is_fsdp(params))
            local, loss, metrics, grads = averaged(params, batch, timer)
            gnorm = tp_norm(grads, params)
            timer.mark("grad_norm")
            out = update(params, opt_state, local, grads, loss, metrics,
                         gnorm)
            timer.mark("update")
            step.split_ms = timer.split()
            return out

        def averaged_grads(params, batch):
            """``(loss, metrics, grads)`` the step updates ``params``
            with on ``batch``: averaged over the data-parallel ranks, the
            gradients this rank's plain tensors (its shards where 'model'
            is above 1 or the tree is FSDP-placed),
            ``metrics["grad_norm"]`` the global norm the step clips them
            by."""
            _, loss, metrics, grads = averaged(params, batch,
                                               _Timer(False, tp))
            gnorm = tp_norm(grads, params)
            return loss, dict(metrics, grad_norm=global_norm(grads)
                              if gnorm is None else gnorm), grads

        step.timed, step.split_ms = False, {}
        step.averaged_grads = averaged_grads
        return step

    mesh_sizes = tuple(mesh.shape)
    coord = mesh.get_coordinate()

    def logical(grads, like):
        """Each leaf's gradient whole: gathered over 'data' along the dim
        its FSDP shard cuts, then over 'model' along the dim its shard
        splits (a strided shard's blocks put back in order)."""
        def one(g, t):
            d = fsdp_dim(t)
            if d is not None:
                g = dgroup.gather_dim(g, d, data_group)
            sh = shard_of(t) if tp > 1 else None
            if sh is None:
                return g
            return unstride(dgroup.gather_dim(g, sh[0], model_group),
                            sh[0], tp, sh[1])
        return tree_map(one, grads, like)

    def pod_step(params, opt_state, err, batch):
        sharded = tp > 1 or is_fsdp(params)
        timer = _Timer(pod_step.timed, tp, is_fsdp(params))
        local = unplace(params)
        loss, metrics, grads = grads_of(local, params, batch, timer)
        if n_data > 1:                  # the in-pod float32 reduction
            grads = reduce_mean(grads, params, [data_group], n_data, [])
        loss, metrics = _mean_metrics(loss, metrics, dp_groups, world)
        timer.mark("in_pod_all_reduce")
        if sharded:
            grads = logical(grads, params)
            timer.mark("model_gather")
        mine = tree_map(lambda e: e[pod:pod + 1], err)
        flat, new_mine = compress_local(grads, mine)
        flat = ring_pad(flat, n_pods)
        timer.mark("compress")
        reduced = ring_allreduce_i8(flat, pod_group)
        timer.mark("ring")
        new_err = tree_map(lambda e: e.clone(), err)
        for e, m in zip(tree_leaves(new_err), tree_leaves(new_mine)):
            e[pod:pod + 1] = m
        full = unflatten_grads(reduced / n_pods, params)
        shards = full if not sharded else tree_map(
            lambda f, t: f[shard_index(f.shape, t.placements, mesh_sizes,
                                       coord)]
            if isinstance(t, DTensor) else f, full, params)
        params, opt_state, metrics = update(params, opt_state, local, shards,
                                            loss, metrics, global_norm(full))
        timer.mark("update")
        pod_step.split_ms = timer.split()
        return params, opt_state, new_err, metrics

    pod_step.timed, pod_step.split_ms = False, {}
    return pod_step


def init_pod_error(params, n_pods: int):
    """Per-pod error-feedback buffers (leading pod dim). Each rank of the
    pod-compressed step reads and writes its own pod's row."""
    return tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (or tensors) as tensors on ``device``."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(
        np.ascontiguousarray(v))).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = "repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10
    straggler_factor: float = 3.0   # step > factor × EWMA ⇒ flag


class Trainer:
    """Checkpoint/restart training loop with preemption + straggler handling.

    Failure model: any step may die (process kill, preemption signal). On
    restart, ``run`` resumes from the newest complete checkpoint, restored
    into the structure of the params and optimizer state it is given.
    Batches (numpy arrays or tensors) go to ``device``: by default the
    current CUDA device, as every entry point of the package; pass
    ``device="cpu"`` for the host.
    """

    def __init__(self, model, opt_cfg: AdamWConfig, cfg: TrainerConfig,
                 train_step: Optional[Callable] = None, monitor=None,
                 device=None):
        from repro_torch.runtime.monitor import StepMonitor
        self.model = model
        self.opt_cfg = opt_cfg
        self.cfg = cfg
        self.device = torch.device("cuda", torch.cuda.current_device()) \
            if device is None else torch.device(device)
        self.train_step = train_step or make_train_step(model, opt_cfg)
        self.monitor = monitor or StepMonitor(cfg.straggler_factor)
        self._preempted = False

    def _install_signal_handler(self) -> Callable[[], None]:
        """SIGTERM sets the preemption flag (main thread only: signal
        handlers live there). Returns what puts the previous handler back."""
        if threading.current_thread() is not threading.main_thread():
            return lambda: None

        def handler(signum, frame):
            self._preempted = True
        old = signal.signal(signal.SIGTERM, handler)
        # None: the previous handler was not installed from Python; the
        # default action is what a process had before
        return lambda: signal.signal(
            signal.SIGTERM, signal.SIG_DFL if old is None else old)

    def run(self, params, data_iter, opt_state=None,
            step_hook: Optional[Callable] = None) -> Tuple[Any, Any, Dict]:
        """Train from the newest checkpoint in ``checkpoint_dir`` (else from
        ``params`` and ``opt_state``) to ``total_steps``; returns (params,
        opt_state, {"history": losses, "stragglers": flagged steps}). The
        SIGTERM handler is installed for the run and removed after it."""
        restore = self._install_signal_handler()
        try:
            return self._run(params, data_iter, opt_state, step_hook)
        finally:
            restore()

    def _run(self, params, data_iter, opt_state, step_hook):
        import torch.distributed as dist
        from repro_torch.checkpoint.checkpointer import Checkpointer
        # a data-parallel step keeps one replica a rank: rank 0 writes it
        ckpt = Checkpointer(self.cfg.checkpoint_dir,
                            async_save=self.cfg.async_checkpoint,
                            writer=not dist.is_initialized()
                            or dist.get_rank() == 0)
        opt_state = opt_state if opt_state is not None else adamw_init(params)
        start_step = 0
        if ckpt.list_steps():
            # DTensor leaves (a tensor-parallel step's) come back on their
            # own placements
            from repro_torch.distributed.sharding import shardings_of
            params, opt_state, start_step = ckpt.restore_latest(
                shardings=(shardings_of(params), shardings_of(opt_state)),
                template=(params, opt_state), device=self.device)
            print(f"[trainer] resumed from step {start_step}", flush=True)
        history = []
        for step in range(start_step, self.cfg.total_steps):
            batch = to_device(next(data_iter), self.device)
            t0 = time.perf_counter()
            params, opt_state, metrics = self.train_step(params, opt_state,
                                                         batch)
            loss = float(metrics["loss"])          # the step's one sync
            dt = time.perf_counter() - t0
            if self.monitor.record(dt):
                print(f"[trainer] straggler: step {step} took {dt*1e3:.0f}ms "
                      f"(ewma {self.monitor.ewma*1e3:.0f}ms)", flush=True)
            history.append(loss)
            if step % self.cfg.log_every == 0:
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms)", flush=True)
            if step_hook is not None:
                step_hook(step, params, metrics)
            done = step + 1
            if done % self.cfg.checkpoint_every == 0 or self._preempted \
                    or done == self.cfg.total_steps:
                ckpt.save(done, params, opt_state)
            if self._preempted:
                print(f"[trainer] preempted at step {done}; "
                      "checkpoint committed, exiting", flush=True)
                break
        ckpt.wait()
        return params, opt_state, {"history": history,
                                   "stragglers": self.monitor.flagged}
