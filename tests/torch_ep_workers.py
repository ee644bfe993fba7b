"""Rank code of the expert-parallel and MoE data-parallel tests:
module-level functions that ``distributed.group.run_local`` runs in gloo
rank processes on the CPU (the tests' directory is on the children's
path), and the pieces the tests compute in their own process. Everything a
rank returns is host data.

The model is moonshot's MoE stack reduced (``get_config(...,
reduced=True)``: 4 experts, top-2) at 2 layers in float32, its weights the
reference's ``init`` carried over by ``convert.from_jax_params`` (the
tests save them to a file the ranks load). The routing and training cases
run at ``capacity_factor`` 1.0, so capacity binds: each expert's buffer
holds the mean load (half the tokens), and the experts above it drop
tokens. (At 0.5 every expert binds, every density is 1/4 and ``moe_aux``
is exactly 1 on any split of the batch.)

The 'expert_ff' fallback (an expert count 'model' does not divide: every
rank holds every expert, cut to its FFN columns) runs 6 experts on
'model' 4 (:data:`FF_EXPERTS`, :data:`FF_TP`; the forward at ``d_ff``
512, so int4 128-groups of ``wdown`` hold whole) and 3 on (data 2, model
2) for training routed over the data ranks, on the port's own ``init``.
"""
import dataclasses

import numpy as np
import torch

import torch_tp_workers as TPW

ARCH = "moonshot-v1-16b-a3b"
BINDING_CF = 1.0
# routing (data parallelism) and training: the reduced widths
ROUTE_OVER = dict(dtype="float32", n_layers=2)
TRAIN_OVER = dict(dtype="float32", n_layers=2, vocab=64)
# the forward: widths where int4 128-groups hold whole at 'model' 4 (wo's
# 512 input columns a quarter each), 'model' 2 and 4 divide the experts,
# the heads and the vocabulary
FWD_OVER = dict(dtype="float32", n_layers=2, d_model=128, n_heads=4,
                n_kv_heads=4, head_dim=128, d_ff=256, vocab=256)
# the 'expert_ff' fallback's forward: 6 experts on 'model' 4, wdown's 512
# input columns 128 a rank (whole int4 128-groups)
FF_EXPERTS = 6
FF_TP = 4
FF_OVER = dict(FWD_OVER, d_ff=512)


def config(over, cf=None, jax=False, experts=None):
    """Reduced moonshot with ``over`` (and ``capacity_factor`` ``cf``,
    ``experts`` experts), the port's config or, with ``jax``, the
    reference's."""
    if jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    cfg = get_config(ARCH, reduced=True)
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    if experts is not None:
        moe = dataclasses.replace(moe, n_experts=experts)
    return dataclasses.replace(cfg, moe=moe, **over)


def model_of(over, cf=None, experts=None):
    from repro_torch.models.model import build_model
    return build_model(config(over, cf, experts=experts))


def port_params(over, experts, path, cf=None):
    """The port's ``init`` (seed 0) of reduced moonshot at ``over`` with
    ``experts`` experts, saved at ``path`` and returned."""
    params = model_of(over, cf, experts).init(
        torch.Generator().manual_seed(0), device="cpu")
    torch.save(params, path)
    return params


def reference_params(over, cf, path, experts=None):
    """The reference's ``init`` (key 0) at ``over`` (with ``experts``
    experts), its params carried over to the port and saved at ``path``:
    ``(jax model, jax params, port params)``."""
    import jax
    from repro.models.model import build_model
    from repro_torch import convert
    jmodel = build_model(config(over, cf, jax=True, experts=experts))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = convert.from_jax_params(jax.device_get(jparams), device="cpu")
    torch.save(tparams, path)
    return jmodel, jparams, tparams


def batch_of(vocab, b=8, s=16, seed=1, n=1):
    """``n`` synthetic batches (numpy tokens and labels)."""
    from repro_torch.data.synthetic import markov_batches
    return [bt for bt, _ in zip(markov_batches(b, s, vocab, seed=seed),
                                range(n))]


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in TPW._leaves(tree)}


# ---------------------------------------------------------------------------
# routing under data parallelism
# ---------------------------------------------------------------------------

# name -> (mesh shape, axis names, microbatches, pod_compress)
ROUTE_CASES = {
    "data2": ((2,), ("data",), 1, False),
    "data2_mb2": ((2,), ("data",), 2, False),
    "data4_mb2": ((4,), ("data",), 2, False),
    "pod2_data2": ((2, 2), ("pod", "data"), 1, False),
    "pod2_data2_compress": ((2, 2), ("pod", "data"), 1, True),
}


def routing_ranks(params_path, batch, names):
    """The data-parallel step of each case of :data:`ROUTE_CASES` in
    ``names`` on the global ``batch``: its loss and metrics, and (plain
    steps) the averaged gradients, from the ranks its mesh covers; the
    routing collectives a step ran."""
    import torch.distributed as dist
    from repro_torch.distributed import group as dgroup
    from repro_torch.distributed.group import make_mesh
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    model = model_of(ROUTE_OVER, BINDING_CF)
    params = torch.load(params_path)
    b = tl.to_device(batch, "cpu")
    out = {"rank": dist.get_rank(), "cases": {}}
    for name in names:
        shape, axes, mb, compress = ROUTE_CASES[name]
        mesh = make_mesh(shape, axes)
        if mesh.get_coordinate() is None:
            continue
        step = tl.make_train_step(model, AdamWConfig(), microbatches=mb,
                                  pod_compress=compress, mesh=mesh)
        calls = dgroup.ROUTING_COLLECTIVES["calls"]
        if compress:
            err = tl.init_pod_error(params, shape[0])
            _, _, _, met = step(params, adamw_init(params), err, b)
            row = {k: float(met[k]) for k in ("loss", "xent", "moe_aux")}
        else:
            loss, met, grads = step.averaged_grads(params, b)
            row = {"loss": float(loss), "xent": float(met["xent"]),
                   "moe_aux": float(met["moe_aux"]), "grads": _np(grads)}
        row["routing_calls"] = dgroup.ROUTING_COLLECTIVES["calls"] - calls
        out["cases"][name] = row
    dist.barrier()
    return out


def jax_accumulated(jmodel, jparams, batch, microbatches):
    """The reference's ``_accumulate_grads`` of ``train_loss`` on
    ``batch`` (one process, the global batch: what its GSPMD step
    computes), jitted: loss, metrics and gradients as numpy."""
    import jax
    import jax.numpy as jnp
    from repro.training.train_loop import _accumulate_grads
    f = jax.jit(lambda p, bt: _accumulate_grads(jmodel.train_loss, p, bt,
                                                microbatches))
    loss, met, grads = f(jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    return (float(loss), {k: float(v) for k, v in met.items()},
            jax.device_get(grads))


# ---------------------------------------------------------------------------
# the expert-parallel forward
# ---------------------------------------------------------------------------

# name -> (bits, group size[, form]) or None: SQuant trees of
# ``quantize_tree``, the same in the ``w_q`` / ``w_q4`` / ``w_scale`` form
# ("serving"), and int4 round-to-nearest codes under one scale per
# 128-group ("group_scales")
FWD_CASES = {
    "fp": None,
    "w8": (8, None),
    "w4_serving": (4, 128, "serving"),
    "w4_group_scales": (4, 128, "group_scales"),
}
# the same trees of the 'expert_ff' fallback's model, at 'model' FF_TP only
FF_CASES = {"ff_" + k: v for k, v in FWD_CASES.items()}
BANK_PATHS = (("stack", "list", "0", "b0", "moe", "wi", "w"),
              ("stack", "list", "1", "b0", "moe", "wdown", "w"),
              ("stack", "list", "0", "b0", "moe", "router", "w"))


def group_scale_tree(params, bits, group_size):
    """``TPW.group_scale_tree`` of the dense kernels, and every expert
    bank ``{"w": (E, in, out)}`` as the pipeline's ``(E·out, in)``
    QuantizedTensor of round-to-nearest codes under one max scale per
    ``group_size`` input columns of each row; the router as it is."""
    from repro_torch.quant.qtypes import from_codes, qmax_for_bits
    from repro_torch.quant.scales import compute_scale

    def one(node, path):
        if isinstance(node, dict):
            w = node.get("w")
            if "router" not in path and isinstance(w, torch.Tensor) and \
                    w.ndim == 3:
                e, din, dout = w.shape
                w2 = w.permute(0, 2, 1).reshape(e * dout, din)
                sc = compute_scale(w2, bits, group_size=group_size)
                q = qmax_for_bits(bits)
                codes = torch.clamp(torch.round(
                    w2 / sc.repeat_interleave(group_size, dim=1)), -q, q)
                return dict(node, w=from_codes(codes.to(torch.int8), sc,
                                               bits, group_size))
            if "router" in path:
                return node
            if isinstance(w, torch.Tensor) and w.ndim == 2:
                return TPW.group_scale_tree(node, bits, group_size)
            return {k: one(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [one(v, path + (str(i),)) for i, v in enumerate(node)]
        return node
    return one(params, ())


def fwd_tree(name, params, mesh=None):
    """The case's whole weight tree from fp ``params``: quantized by
    ``quantize_tree`` over ``mesh``'s ranks (row slabs, then gathered)
    where a quantize mesh is given."""
    from repro_torch.core import pipeline
    from repro_torch.distributed.sharding import gather_tree
    quant = {**FWD_CASES, **FF_CASES}[name]
    if quant is None:
        return params
    bits, gs = quant[:2]
    if quant[2:] == ("group_scales",):
        return group_scale_tree(params, bits, gs)
    if quant[2:] == ("serving",):
        from repro_torch.quant.apply import quantize_params_serving
        return quantize_params_serving(params, bits, "squant", gs)[0]
    tree, _ = pipeline.quantize_tree(params, method="squant", bits=bits,
                                     group_size=gs, device="cpu", mesh=mesh)
    return gather_tree(tree) if mesh is not None else tree


def forward_with_routes(model, tree):
    """``TPW.forward_suite``'s logits and every routing's expert indices
    (each MoE layer of each forward, in order)."""
    from repro_torch.models.moe import recording_routes
    with recording_routes() as log:
        logits = TPW.forward_suite(model, tree)
    return logits, [r.numpy().copy() for r in log]


def bank_node(tree, path):
    """The bank at ``path`` (``.../<bank>/w``): the kernel, or the
    serving form's ``{"w_q" | "w_q4", "w_scale"}`` dict at ``.../<bank>``."""
    node = TPW._at(tree, path)
    return TPW._at(tree, path[:-1]) if node is None else node


def _bank_parts(node):
    """Codes, scale and logical shape of a bank (or a router's fp
    kernel) as numpy: a QuantizedTensor's, a ``w_q`` / ``w_q4`` dict's, or
    a plain tensor's (no scale)."""
    from repro_torch.quant.qtypes import QuantizedTensor
    if isinstance(node, QuantizedTensor):
        return node.data.numpy(), node.scale.numpy(), tuple(node.shape)
    if isinstance(node, dict):
        q = node.get("w_q", node.get("w_q4"))
        return q.numpy(), node["w_scale"].numpy(), tuple(q.shape)
    return node.numpy(), None, tuple(node.shape)


def fwd_model(name):
    """The forward case's model: the 'expert_ff' fallback's for
    :data:`FF_CASES`, else :data:`FWD_OVER`'s."""
    if name in FF_CASES:
        return model_of(FF_OVER, experts=FF_EXPERTS)
    return model_of(FWD_OVER)


def forward_ranks(tp, params_path, names, ff_path=None):
    """Every case of ``names`` on a ``(world / tp, tp)`` ('data', 'model')
    mesh (the cases of :data:`FF_CASES` on the params at ``ff_path``): the
    whole tree quantized over the group's ranks, cut by ``tp_local``, the
    suite run under the mesh. Returns the rank's logits and expert picks
    by case, and its local banks of :data:`BANK_PATHS`."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import activate_mesh, tp_local
    from repro_torch.launch.mesh import make_quantize_mesh
    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    params = {False: torch.load(params_path),
              True: torch.load(ff_path) if ff_path else None}
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
           "logits": {}, "routes": {}, "banks": {}}
    for name in names:
        model = fwd_model(name)
        local = tp_local(fwd_tree(name, params[name in FF_CASES], qmesh),
                         mesh, model.cfg)
        with activate_mesh(mesh):
            out["logits"][name], out["routes"][name] = forward_with_routes(
                model, local)
        out["banks"][name] = {"/".join(p): _bank_parts(bank_node(local, p))
                              for p in BANK_PATHS}
    return out


# ---------------------------------------------------------------------------
# the expert-parallel train step
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
# name -> (mesh shape, axis names, microbatches, experts: None for the
# reduced config's 4 on the reference's init, else the port's init with
# that many, which 'model' does not divide: the 'expert_ff' fallback)
TRAIN_CASES = {
    "data2_model2": ((2, 2), ("data", "model"), 1, None),
    "data2_model2_mb2": ((2, 2), ("data", "model"), 2, None),
    "data1_model4": ((1, 4), ("data", "model"), 1, None),
    "ff_data1_model4": ((1, 4), ("data", "model"), 1, FF_EXPERTS),
    "ff_data2_model2": ((2, 2), ("data", "model"), 1, 3),
}
FF_TRAIN_EXPERTS = (FF_EXPERTS, 3)


def one_rank_train(params, microbatches, steps=TRAIN_STEPS, experts=None):
    """The plain one-rank step's losses, grad norms and final params, and
    its gradients of the first batch."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = model_of(TRAIN_OVER, BINDING_CF, experts)
    batches = [tl.to_device(b, "cpu") for b in
               batch_of(model.cfg.vocab, n=steps)]
    _, _, g = tl._accumulate_grads(model.train_loss, params, batches[0],
                                   microbatches)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**TPW._STEP),
                              microbatches=microbatches)
    losses, norms = [], []
    for b in batches:
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, _np(params), _np(g)


def pod_metrics(params, n_pods=2):
    """The first batch's loss and ``moe_aux`` as the pod-compressed step
    reports them: each pod's slice routed alone (one rank here), the
    metrics averaged over the pods."""
    from repro_torch.training import train_loop as tl
    model = model_of(TRAIN_OVER, BINDING_CF)
    b = tl.to_device(batch_of(model.cfg.vocab)[0], "cpu")
    per = next(iter(b.values())).shape[0] // n_pods
    rows = []
    for p in range(n_pods):
        mine = {k: v[p * per:(p + 1) * per] for k, v in b.items()}
        loss, met, _ = tl._value_and_grad(model.train_loss, params, mine)
        rows.append((float(loss), float(met["moe_aux"])))
    return tuple(float(np.mean(c)) for c in zip(*rows))


def _whole_grads(mesh, placed, local_grads):
    """Local shard gradients placed as ``placed`` is, gathered whole."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.training.optimizer import tree_map
    return gather_tree(tree_map(lambda g, t: DTensor.from_local(
        g, mesh, t.placements, run_check=False, shape=t.shape,
        stride=t.stride()), local_grads, placed))


def train_ranks(params_path, ff_paths=None):
    """Every case of :data:`TRAIN_CASES` (the 'expert_ff' ones on the
    params at ``ff_paths[experts]``): the expert-parallel step's averaged
    gradients of the first batch (gathered whole), then
    :data:`TRAIN_STEPS` steps' losses, grad norms and this rank's final
    shards; and the pod-compressed step on (pod 2, data 1, model 2): its
    first step's loss and ``moe_aux``, and that its error-feedback
    buffers keep the logical shapes."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    torch.set_num_threads(1)
    model = model_of(TRAIN_OVER, BINDING_CF)
    params = torch.load(params_path)
    batches = [tl.to_device(b, "cpu") for b in
               batch_of(model.cfg.vocab, n=TRAIN_STEPS)]
    out = {"rank": dist.get_rank(), "cases": {}}
    for name, (shape, axes, mb, experts) in TRAIN_CASES.items():
        if experts is not None and not ff_paths:
            continue
        mesh = make_mesh(shape, axes)
        m = model if experts is None else model_of(TRAIN_OVER, BINDING_CF,
                                                   experts)
        p = params if experts is None else torch.load(ff_paths[experts])
        placed = tp_place(p, mesh, m.cfg)
        step = tl.make_train_step(m, AdamWConfig(**TPW._STEP),
                                  microbatches=mb, mesh=mesh)
        _, _, g = step.averaged_grads(placed, batches[0])
        grads = _np(_whole_grads(mesh, placed, g))
        opt = adamw_init(placed)
        losses, norms = [], []
        for b in batches:
            placed, opt, met = step(placed, opt, b)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        out["cases"][name] = (losses, norms, TPW._shards(placed), grads)
    mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    err = tl.init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    placed = tp_place(params, mesh, model.cfg)
    step = tl.make_train_step(model, AdamWConfig(**TPW._STEP),
                              pod_compress=True, mesh=mesh)
    _, _, err, met = step(placed, adamw_init(placed), err, batches[0])
    out["pod"] = {"loss": float(met["loss"]),
                  "moe_aux": float(met["moe_aux"]),
                  "err_shapes_kept": [tuple(e.shape) for e in
                                      tree_leaves(err)] == shapes}
    dist.barrier()
    return out


def reference_moe_ranks(params_path, tokens, batch, ff=None):
    """The port's side of the reference (GSPMD) comparison on (data 2,
    model 2): prefill logits of ``tokens`` on the expert-parallel local
    tree, and the step's averaged loss and gradients of ``batch``
    (gathered whole) and one step's metrics, as rank 0 holds them; with
    ``ff`` ((params path, tokens, batch) of :data:`FF_EXPERTS` experts),
    the same on (data 1, model 4) under the 'expert_ff' fallback, as
    ``"ff"``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    out = _reference_moe_side(params_path, tokens, batch, (2, 2))
    if ff is not None:
        out["ff"] = _reference_moe_side(*ff, (1, 4), FF_EXPERTS)
    return out if dist.get_rank() == 0 else None


def _reference_moe_side(params_path, tokens, batch, shape, experts=None):
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (activate_mesh, tp_local,
                                                  tp_place)
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = model_of(TRAIN_OVER, BINDING_CF, experts)
    params = torch.load(params_path)
    mesh = make_mesh(shape, ("data", "model"))
    toks = torch.from_numpy(tokens)
    with activate_mesh(mesh):
        logits, _ = model.forward(
            tp_local(params, mesh, model.cfg), {"tokens": toks}, mode="prefill",
            caches=model.init_cache(toks.shape[0], toks.shape[1],
                                    device="cpu"))
    placed = tp_place(params, mesh, model.cfg)
    step = tl.make_train_step(model, AdamWConfig(), mesh=mesh)
    b = tl.to_device(batch, "cpu")
    loss, _, g = step.averaged_grads(placed, b)
    grads = _np(_whole_grads(mesh, placed, g))
    _, _, met = step(placed, adamw_init(placed), b)
    return {"logits": logits.numpy(), "loss": float(loss), "grads": grads,
            "step": {k: float(met[k]) for k in ("loss", "grad_norm")}}


# ---------------------------------------------------------------------------
# checkpoint of an expert-placed tree
# ---------------------------------------------------------------------------

def checkpoint_ranks(params_path, ckpt_dir, ff_path=None):
    """A ``tp_place``d tree and its AdamW state on (data 1, model 4)
    saved (collective), then restored with ``restore(shardings=)`` onto
    (data 1, model 2) (ranks 0 and 1) and onto one rank (rank 0, plain
    tensors): each restored leaf gathered whole, as numpy, and the local
    shard shapes of an expert bank on each mesh; with ``ff_path``, the
    same (keys ``ff_...``) for the 'expert_ff' fallback's
    :data:`FF_EXPERTS` experts on 'model' 4, whose restore on 'model' 2
    cuts the banks by experts instead."""
    out = _checkpoint_ranks(params_path, ckpt_dir, config(TRAIN_OVER))
    if ff_path:
        ff = _checkpoint_ranks(ff_path, ckpt_dir + "_ff", config(
            TRAIN_OVER, experts=FF_EXPERTS))
        out.update({"ff_" + k: v for k, v in ff.items() if k != "rank"})
    return out


def _checkpoint_ranks(params_path, ckpt_dir, cfg):
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (gather_tree, shardings_of,
                                                  tp_place)
    from repro_torch.training.optimizer import adamw_init
    torch.set_num_threads(1)
    params = torch.load(params_path)
    bank = ("stack", "list", "0", "b0", "moe", "wg", "w")
    mesh4 = make_mesh((1, 4), ("data", "model"))
    placed = tp_place(params, mesh4, cfg)
    opt = adamw_init(placed)
    ck = Checkpointer(ckpt_dir, async_save=False)
    ck.save(1, placed, opt)
    down = bank[:-2] + ("wdown", "w")
    out = {"rank": dist.get_rank(),
           "local4": tuple(TPW._at(placed, bank).to_local().shape),
           "local4_down": tuple(TPW._at(placed, down).to_local().shape)}
    mesh2 = make_mesh((1, 2), ("data", "model"))
    if mesh2.get_coordinate() is not None:
        like = tp_place(params, mesh2, cfg)
        got, got_opt, _ = ck.restore(
            1, shardings=(shardings_of(like), shardings_of(
                adamw_init(like))), template=(like, adamw_init(like)),
            device="cpu")
        out["local2"] = tuple(TPW._at(got, bank).to_local().shape)
        out["local2_down"] = tuple(TPW._at(got, down).to_local().shape)
        whole = gather_tree(got)
        out["model2"] = _np(whole)
        out["model2_opt_m"] = _np(gather_tree(got_opt["m"]))
    dist.barrier()
    if dist.get_rank() == 0:
        one, _, _ = ck.restore(1, template=(params, adamw_init(params)),
                               device="cpu")
        out["one_rank"] = _np(one)
    dist.barrier()
    return out
