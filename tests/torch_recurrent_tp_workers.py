"""Rank code of the mamba and rwkv tensor-parallel tests: module-level
functions that ``distributed.group.run_local`` runs in gloo rank processes
on the CPU (the tests' directory is on the children's path), and the
one-rank runs the tests hold them against. Everything returned is host
data.

jamba: reduced jamba (4 experts, top-2, every other layer an MoE) at
:data:`JAMBA_TINY`: d_model 128 (``d_inner`` 256), 8 q / 4 KV heads of
32 (the reduced config's one KV head divides no 'model' axis), ``d_ff``
256, a 4-layer period ``("m", "m", "a", "m")`` (mamba with a dense FFN
and with an MoE, and attention) and ``mamba_chunk`` 8, so a prompt of 32
tokens runs the chunked scan. rwkv: reduced rwkv at :data:`RWKV_TINY`:
d_model 256 (8 heads of 32), ``d_ff`` 256, ``rwkv_chunk`` 8 (the
chunkwise-parallel WKV), 2 layers.

An int4 tree with one scale per 128-group (:func:`group_scale_tree`, the
group kernel B takes) holds whole groups on every row-parallel shard at
'model' 2: jamba's ``out_proj``, ``x_proj``, ``wo`` and ``wdown`` and
rwkv's ``wo`` and channel-mix ``wv`` have 256 input columns, 128 a rank.
At 'model' 4 they split a group, and ``tp_local`` refuses them.
"""
import dataclasses

import torch

import torch_tp_workers as TPW

JAMBA_TINY = dict(dtype="float32", n_layers=4, d_model=128, n_heads=8,
                  n_kv_heads=4, head_dim=32, d_ff=256, mamba_chunk=8,
                  block_pattern=("m", "m", "a", "m"))
RWKV_TINY = dict(dtype="float32", n_layers=2, d_model=256, n_heads=8,
                 n_kv_heads=8, d_ff=256, rwkv_head_dim=32, rwkv_chunk=8)
W4_GROUP = 128
W4G_MAX_TP = 2
BINDING_CF = 1.0      # jamba's training: capacity = the mean load
MAX_LEN = 48

# name -> (bits, form) or None for fp: SQuant over the ranks' row slabs,
# or int4 round-to-nearest codes under per-group scales
CASES = {"fp": None, "w8": (8, "squant"), "w4g": (4, "group_scales")}
KINDS = ("jamba", "rwkv")


def config(kind, cf=None, jax=False, **over):
    """The kind's config at its test widths (and ``over``, and
    ``capacity_factor`` ``cf`` where given): the port's or, with ``jax``,
    the reference's."""
    if jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    if kind == "rwkv":
        return dataclasses.replace(get_config("rwkv6-1.6b", reduced=True),
                                   **dict(RWKV_TINY, **over))
    cfg = get_config("jamba-1.5-large-398b", reduced=True)
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    return dataclasses.replace(cfg, moe=moe, **dict(JAMBA_TINY, **over))


def model_of(kind, cf=None, **over):
    from repro_torch.models.model import build_model
    return build_model(config(kind, cf, **over))


def params_of(model, seed=0):
    return model.init(torch.Generator().manual_seed(seed), device="cpu")


def group_scale_tree(params, bits, group_size):
    """Every dense kernel ``{"w": (in, out)}`` of ``params`` as a
    ``QuantizedTensor`` of round-to-nearest codes under one max scale per
    ``group_size`` input columns of each output row, or one scale a row
    where ``group_size`` does not divide the inputs (mamba's ``dt_proj``,
    rwkv's decay LoRA); expert banks and the router as they are."""
    from repro_torch.quant.qtypes import from_codes, qmax_for_bits
    from repro_torch.quant.scales import compute_scale

    def one(node):
        if isinstance(node, dict):
            w = node.get("w")
            if isinstance(w, torch.Tensor) and w.ndim == 2:
                w = w.T.contiguous().to(torch.float32)
                gs = group_size if w.shape[1] % group_size == 0 else None
                sc = compute_scale(w, bits, group_size=gs)
                q = qmax_for_bits(bits)
                full = sc if gs is None else sc.repeat_interleave(gs, dim=1)
                codes = torch.clamp(torch.round(w / full), -q, q)
                return dict(node, w=from_codes(codes.to(torch.int8), sc,
                                               bits, gs))
            return {k: (v if k == "router" else one(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [one(v) for v in node]
        return node
    return one(params)


def quantized(kind, params, quant, mesh=None):
    """``params`` as the case's tree: fp, SQuant over ``mesh``'s ranks'
    row slabs (gathered) or on one rank, or int4 per-group."""
    from repro_torch.core import pipeline
    from repro_torch.distributed.sharding import gather_tree
    if quant is None:
        return params
    bits, form = quant
    if form == "group_scales":
        return group_scale_tree(params, bits, W4_GROUP)
    tree, _ = pipeline.quantize_tree(params, method="squant", bits=bits,
                                     device="cpu", mesh=mesh)
    return gather_tree(tree) if mesh is not None else tree


def case(kind, name, mesh=None):
    model = model_of(kind)
    return model, quantized(kind, params_of(model), CASES[name], mesh)


def suite(model, tree):
    """Float32 numpy logits (and every routing's expert picks) of a
    32-token prefill (the chunked scan) and three decode steps after it,
    and of chunks of 16, 8 and 8 tokens then two decode steps, on a
    contiguous cache of :data:`MAX_LEN` positions; under whatever mesh is
    active."""
    from repro_torch.models.moe import recording_routes
    v = model.cfg.vocab
    out = {}
    with recording_routes() as log:
        toks = TPW.prompt(v, s=32)
        lg, caches = model.prefill(tree, {"tokens": toks},
                                   model.init_cache(2, MAX_LEN,
                                                    device="cpu"))
        out["prefill"] = lg.float().numpy()
        nxt = TPW.prompt(v, s=3, seed=4)
        for j in range(3):
            lg, caches = model.decode_step(tree, nxt[:, j:j + 1], caches)
            out[f"decode{j}"] = lg.float().numpy()
        caches = model.init_cache(2, MAX_LEN, device="cpu")
        for i, (a, b) in enumerate(((0, 16), (16, 24), (24, 32))):
            lg, caches = model.prefill_chunk(tree, {"tokens": toks[:, a:b]},
                                             caches)
            out[f"chunk{i}"] = lg.float().numpy()
        for j in range(2):
            lg, caches = model.decode_step(tree, nxt[:, j:j + 1], caches)
            out[f"chunk_decode{j}"] = lg.float().numpy()
    return out, [r.numpy().copy() for r in log]


def one_rank(kind, name):
    return suite(*case(kind, name))


def names_at(tp):
    return [n for n, q in CASES.items()
            if not (q and q[1] == "group_scales" and tp > W4G_MAX_TP)]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

MIXER_LEAVES = {"jamba": ("stack", "list", "0", "b0", "mixer"),
                "rwkv": ("stack", "list", "0", "b0")}


def _shapes(node):
    """``{path: shape}`` of a mixer's leaves (codes' logical shapes)."""
    return {k: tuple(v.shape) for k, v in TPW._leaves(node)}


def _mamba_collectives(cfg, mixer, mesh):
    """The 'model' collectives one mamba mixer runs on this rank's shards
    in a prefill of 8 tokens (one chunk of the scan) and of 32 (four)."""
    from repro_torch.distributed import group
    from repro_torch.distributed.sharding import activate_mesh
    from repro_torch.models.mamba import mamba
    out = {}
    for s in (8, 32):
        x = torch.randn((2, s, cfg.d_model),
                        generator=torch.Generator().manual_seed(s))
        c0 = group.MODEL_COLLECTIVES["calls"]
        with activate_mesh(mesh), torch.no_grad():
            mamba(mixer, x, d_state=cfg.mamba.d_state, mode="prefill",
                  chunk=cfg.mamba_chunk,
                  dt_rank=mixer["dt_proj"]["w"].shape[0])
        out[f"{'chunk' if s == 8 else 'prefill'}{s}"] = \
            group.MODEL_COLLECTIVES["calls"] - c0
    return out


def forward_ranks(tp, names):
    """Every case of ``names`` for both kinds on a ``(world / tp, tp)``
    ('data', 'model') mesh: each whole tree quantized over the group's
    ranks, cut by ``tp_local``, run under the mesh, with the
    tensor-parallel collectives counted. Returns the rank's logits and
    expert picks by kind and case, its local mixer shapes, the int8
    ``in_proj`` codes it holds, its caches' shapes, and what an int4
    per-group cut past :data:`W4G_MAX_TP` raised."""
    import torch.distributed as dist
    from repro_torch.distributed import group
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import activate_mesh, tp_local
    from repro_torch.launch.mesh import make_quantize_mesh
    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
           "logits": {}, "routes": {}, "shapes": {}, "cache": {},
           "raised": {}}
    for kind in KINDS:
        for name in names:
            model, whole = case(kind, name, qmesh)
            local = tp_local(whole, mesh, model.cfg)
            with activate_mesh(mesh):
                key = f"{kind}_{name}"
                out["logits"][key], out["routes"][key] = suite(model, local)
            if name == "w8" and kind == "jamba":
                qt = TPW._at(local, MIXER_LEAVES[kind] + ("in_proj", "w"))
                out["in_proj_w8"] = (qt.data.numpy(), qt.scale.numpy())
        model, whole = case(kind, "fp")
        local = tp_local(whole, mesh, model.cfg)
        out["shapes"][kind] = _shapes(TPW._at(local, MIXER_LEAVES[kind]))
        with activate_mesh(mesh):
            c = model.init_cache(2, 8, device="cpu")["list"][0]["b0"]
            out["cache"][kind] = {k: tuple(v.shape) for k, v in c.items()}
            # the collectives of one decode step
            caches = model.init_cache(2, 8, device="cpu")
            _, caches = model.prefill(local, {"tokens": TPW.prompt(
                model.cfg.vocab, s=4)}, caches)
            c0 = group.MODEL_COLLECTIVES["calls"]
            model.decode_step(local, TPW.prompt(model.cfg.vocab, s=1),
                              caches)
            out[f"{kind}_decode_collectives"] = \
                group.MODEL_COLLECTIVES["calls"] - c0
        if kind == "jamba":
            out["mamba_collectives"] = _mamba_collectives(
                model.cfg, TPW._at(local, MIXER_LEAVES[kind]), mesh)
        if tp > W4G_MAX_TP:
            try:
                m4, t4 = case(kind, "w4g")
                tp_local(t4, mesh, m4.cfg)
            except ValueError as e:
                out["raised"][kind] = str(e)
    return out


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
TRAIN_VOCAB = 64                 # 'model' 2 and 4 divide it: vocab-parallel
TRAIN_SEQ = 16                   # two chunks of the chunked scan / WKV
# name -> (mesh shape, axis names)
TRAIN_CASES = {"data2_model2": ((2, 2), ("data", "model")),
               "data1_model4": ((1, 4), ("data", "model"))}


def train_model(kind):
    """The training cases' model at vocabulary :data:`TRAIN_VOCAB`; jamba
    at capacity factor :data:`BINDING_CF` (capacity binds, so routing the
    global batch and routing each data rank's slice differ)."""
    return model_of(kind, BINDING_CF if kind == "jamba" else None,
                    vocab=TRAIN_VOCAB)


def train_batches(n=TRAIN_STEPS):
    return TPW.train_batches(TRAIN_VOCAB, n, s=TRAIN_SEQ)


def one_rank_train(kind, steps=TRAIN_STEPS):
    """The plain one-rank step's losses, grad norms and final params, and
    its gradients of the first batch."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = train_model(kind)
    params = params_of(model)
    batches = [tl.to_device(b, "cpu") for b in train_batches(steps)]
    _, _, g = tl._value_and_grad(model.train_loss, params, batches[0])
    grads = {k: v.numpy() for k, v in TPW._leaves(g)}
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**TPW._STEP))
    losses, norms = [], []
    for b in batches:
        params, opt, met = step(params, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, {k: v.detach().numpy() for k, v in
                           TPW._leaves(params)}, grads


def shards(tree):
    """``{path: (local numpy, index)}`` of a DTensor tree on this rank:
    each dim's ``(start, stop)``, or a strided shard's positions."""
    from repro_torch.distributed.sharding import shard_index
    out = {}
    for k, t in TPW._leaves(tree):
        idx = shard_index(t.shape, t.placements, tuple(t.device_mesh.shape),
                          t.device_mesh.get_coordinate())
        out[k] = (t.to_local().detach().numpy().copy(),
                  tuple((s.start, s.stop) if isinstance(s, slice)
                        else s.numpy() for s in idx))
    return out


def _tp_train(kind, mesh):
    """The tensor-parallel step's averaged gradients of the first batch
    (gathered whole), then its losses, grad norms and this rank's final
    shards over :data:`TRAIN_STEPS` steps."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    import torch_ep_workers as EP
    model = train_model(kind)
    placed = tp_place(params_of(model), mesh, model.cfg)
    batches = [tl.to_device(b, "cpu") for b in train_batches()]
    step = tl.make_train_step(model, AdamWConfig(**TPW._STEP), mesh=mesh)
    _, _, g = step.averaged_grads(placed, batches[0])
    grads = EP._np(EP._whole_grads(mesh, placed, g))
    opt = adamw_init(placed)
    losses, norms = [], []
    for b in batches:
        placed, opt, met = step(placed, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, shards(placed), grads


def _pod_losses(kind, mesh, tp):
    """The pod-compressed step on ``mesh`` (tensor-parallel when ``tp``):
    its losses over :data:`TRAIN_STEPS` steps and whether the
    error-feedback buffers kept their logical shapes."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    model = train_model(kind)
    params = params_of(model)
    err = tl.init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    if tp:
        params = tp_place(params, mesh, model.cfg)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**TPW.POD_OPT),
                              pod_compress=True, mesh=mesh)
    losses = []
    for b in train_batches():
        params, opt, err, met = step(params, opt, err,
                                     tl.to_device(b, "cpu"))
        losses.append(float(met["loss"]))
    return {"losses": losses, "shapes_kept": [
        tuple(e.shape) for e in tree_leaves(err)] == shapes}


def train_ranks():
    """Every case of :data:`TRAIN_CASES` for both kinds, and jamba's
    pod-compressed step on (pod 2, data 1, model 2) beside the
    non-tensor-parallel pod step on (pod 2, data 1) (ranks 0 and 1)."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "cases": {}}
    for kind in KINDS:
        for name, (shape, axes) in TRAIN_CASES.items():
            out["cases"][f"{kind}_{name}"] = _tp_train(
                kind, make_mesh(shape, axes))
    out["pod_tp"] = _pod_losses("jamba", make_mesh(
        (2, 1, 2), ("pod", "data", "model")), True)
    plain = make_mesh((2, 1), ("pod", "data"))
    if plain.get_coordinate() is not None:
        out["pod_plain"] = _pod_losses("jamba", plain, False)
    dist.barrier()
    return out


def ranks_of(tp, names, train):
    """:func:`forward_ranks`, then :func:`train_ranks` where ``train``,
    in one set of rank processes."""
    out = forward_ranks(tp, names)
    out["train"] = train_ranks() if train else None
    return out


# ---------------------------------------------------------------------------
# a checkpoint of a tensor-parallel jamba tree
# ---------------------------------------------------------------------------

IN_PROJ = ("stack", "list", "0", "b0", "mixer", "in_proj", "w")


def checkpoint_ranks(ckpt_dir):
    """Reduced jamba's params and AdamW state ``tp_place``d on (data 1,
    model 4) (``in_proj``'s paired cut a strided shard) saved
    (collective), then restored with ``restore(shardings=)`` onto (data 1,
    model 2) (ranks 0 and 1) and onto one rank (rank 0, plain tensors):
    each restored leaf gathered whole, as numpy, the local ``in_proj``
    shard on each mesh, and DTensor's own gather of the placed one."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (gather_tree, shardings_of,
                                                  tp_place)
    from repro_torch.training.optimizer import adamw_init
    import torch_ep_workers as EP
    torch.set_num_threads(1)
    model = train_model("jamba")
    params = params_of(model)
    mesh4 = make_mesh((1, 4), ("data", "model"))
    placed = tp_place(params, mesh4, model.cfg)
    opt = adamw_init(placed)
    ck = Checkpointer(ckpt_dir, async_save=False)
    ck.save(1, placed, opt)
    w = TPW._at(placed, IN_PROJ)
    # DTensor's own gather of the strided shard: the port's layout is its
    out = {"rank": dist.get_rank(), "local4": w.to_local().numpy().copy(),
           "placements4": repr(w.placements),
           "dtensor_gather": w.full_tensor().numpy().copy()}
    mesh2 = make_mesh((1, 2), ("data", "model"))
    if mesh2.get_coordinate() is not None:
        like = tp_place(params, mesh2, model.cfg)
        got, got_opt, _ = ck.restore(
            1, shardings=(shardings_of(like), shardings_of(
                adamw_init(like))), template=(like, adamw_init(like)),
            device="cpu")
        out["local2"] = TPW._at(got, IN_PROJ).to_local().numpy().copy()
        out["model2"] = EP._np(gather_tree(got))
        out["model2_opt_m"] = EP._np(gather_tree(got_opt["m"]))
    dist.barrier()
    if dist.get_rank() == 0:
        one, _, _ = ck.restore(1, template=(params, adamw_init(params)),
                               device="cpu")
        out["one_rank"] = EP._np(one)
        out["saved"] = EP._np(params)
    dist.barrier()
    return out


# ---------------------------------------------------------------------------
# the reference's GSPMD forward and step
# ---------------------------------------------------------------------------

# the reference comparison's jamba: one period of attention with a dense
# FFN, then mamba with an MoE (half the compile time of the 4-layer one)
REF_JAMBA = dict(n_layers=2, block_pattern=("a", "m"))


def reference_config(kind, jax=False):
    """The reference comparison's config: :func:`config` at vocabulary
    :data:`TRAIN_VOCAB`, jamba at :data:`BINDING_CF` and
    :data:`REF_JAMBA`."""
    if kind == "jamba":
        return config(kind, BINDING_CF, jax=jax, vocab=TRAIN_VOCAB,
                      **REF_JAMBA)
    return config(kind, jax=jax, vocab=TRAIN_VOCAB)


def reference_ranks(cases):
    """The port's side of the reference comparison on (data 2, model 2),
    for each ``kind -> (params path, tokens, batch)`` of ``cases``: the
    prefill logits of ``tokens`` on the tensor-parallel local tree, the
    step's averaged loss and gradients of ``batch`` (gathered whole) and
    one step's metrics, as rank 0 holds them."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (activate_mesh, tp_local,
                                                  tp_place)
    from repro_torch.models.model import build_model
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    import torch_ep_workers as EP
    torch.set_num_threads(1)
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for kind, (path, tokens, batch) in cases.items():
        model = build_model(reference_config(kind))
        params = torch.load(path)
        toks = torch.from_numpy(tokens)
        with activate_mesh(mesh):
            logits, _ = model.forward(
                tp_local(params, mesh, model.cfg), {"tokens": toks}, mode="prefill",
                caches=model.init_cache(*toks.shape, device="cpu"))
        placed = tp_place(params, mesh, model.cfg)
        step = tl.make_train_step(model, AdamWConfig(), mesh=mesh)
        b = tl.to_device(batch, "cpu")
        loss, _, g = step.averaged_grads(placed, b)
        grads = EP._np(EP._whole_grads(mesh, placed, g))
        _, _, met = step(placed, adamw_init(placed), b)
        out[kind] = {"logits": logits.numpy(), "loss": float(loss),
                     "grads": grads, "step": {k: float(met[k]) for k in
                                              ("loss", "grad_norm")}}
    return out if dist.get_rank() == 0 else None
