"""Rank code of the MLA and sliding-window tensor-parallel tests:
module-level functions that ``distributed.group.run_local`` runs in gloo
rank processes on the CPU (the tests' directory is on the children's
path), and the one-rank runs the tests hold them against. Everything
returned is host data.

MLA: minicpm3 at test widths (:data:`MLA_TINY`, :data:`MLA_DIMS`): d_model
128, 8 heads, latent ranks 128 (``q_lora``, ``kv_lora``), so 'model' 2
and 4 divide every sharded dim (``kv_down``'s 136 outputs too) and an
int4 128-group shard of ``wo`` / ``wdown`` (256 input columns) holds
whole groups at 'model' 2 only.

The ring: reduced mixtral (4 experts, top-2, a 32-token window) with 8 q
and 4 KV heads of 16 (:data:`RING_TINY`; the reduced config's one KV head
divides no 'model' axis), on a 64-position cache, so the ring holds 32
slots and the prompts, chunks and decode steps of :func:`ring_suite` run
past it and wrap it.
"""
import dataclasses

import torch

import torch_tp_workers as TPW

MLA_TINY = dict(dtype="float32", n_layers=2, d_model=128, n_heads=8,
                n_kv_heads=8, d_ff=256, vocab=256)
MLA_DIMS = dict(q_lora=128, kv_lora=128, nope_dim=16, rope_dim=8, v_dim=32)
RING_TINY = dict(dtype="float32", n_layers=2, n_heads=8, n_kv_heads=4,
                 window=32)
RING_MAX_LEN = 64
BINDING_CF = 1.0      # the ring's training: capacity = the mean load

# name -> (config overrides, (bits, group_size[, form]) or None for fp);
# "absorb" decodes in the compressed space (MLAConfig.absorb)
MLA_CASES = {
    "fp": ({}, None),
    "w8": ({}, (8, None)),
    "w4_group_scales": ({}, (4, 128, "group_scales")),
    "absorb_fp": (dict(absorb=True), None),
    "absorb_w8": (dict(absorb=True), (8, None)),
    "bf16_w8": (dict(dtype="bfloat16"), (8, None)),
}
W4G_MAX_TP = 2        # wo's and wdown's 256 input columns: whole 128-groups
RING_CASES = {"fp": None, "w8": (8, None)}


def mla_model(absorb=False, **over):
    """minicpm3 at :data:`MLA_TINY` (and ``over``) with :data:`MLA_DIMS`."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MLAConfig
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("minicpm3-4b", reduced=True),
                              mla=MLAConfig(**MLA_DIMS, absorb=absorb),
                              **dict(MLA_TINY, **over))
    return build_model(cfg)


def ring_model(cf=None, **over):
    """Reduced mixtral at :data:`RING_TINY` (and ``over``, and
    ``capacity_factor`` ``cf`` where given)."""
    from repro_torch.models.model import build_model
    return build_model(ring_config(cf, **over))


def ring_config(cf=None, jax=False, **over):
    """Reduced mixtral's config at :data:`RING_TINY` and ``over``: the
    port's or, with ``jax``, the reference's."""
    if jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    cfg = get_config("mixtral-8x7b", reduced=True)
    moe = cfg.moe if cf is None else dataclasses.replace(
        cfg.moe, capacity_factor=cf)
    return dataclasses.replace(cfg, moe=moe, **dict(RING_TINY, **over))


def params_of(model, seed=0):
    return model.init(torch.Generator().manual_seed(seed), device="cpu")


def quantized(params, quant, mesh=None):
    """``params`` as the case's tree: fp, SQuant over ``mesh``'s ranks'
    row slabs (gathered) or on one rank, or int4 round-to-nearest codes
    under one scale per 128-group."""
    from repro_torch.core import pipeline
    from repro_torch.distributed.sharding import gather_tree
    if quant is None:
        return params
    bits, gs = quant[:2]
    if quant[2:] == ("group_scales",):
        return TPW.group_scale_tree(params, bits, gs)
    tree, _ = pipeline.quantize_tree(params, method="squant", bits=bits,
                                     group_size=gs, device="cpu", mesh=mesh)
    return gather_tree(tree) if mesh is not None else tree


def mla_case(name, mesh=None):
    """The MLA case's model and whole tree (quantized over ``mesh``)."""
    over, quant = MLA_CASES[name]
    model = mla_model(**over)
    return model, quantized(params_of(model), quant, mesh)


def ring_suite(model, tree):
    """Float32 numpy logits of the ring's paths on a cache of
    :data:`RING_MAX_LEN` positions (32 ring slots): a 40-token prefill
    (past the ring) and three decode steps; a 29-token prefill and five
    decode steps across the ring's end (positions 29-33); and chunks of
    20, 20 (wrapping the ring) and 8 tokens."""
    from repro_torch.models.moe import recording_routes
    v = model.cfg.vocab
    out = {}
    with recording_routes() as log:
        toks = TPW.prompt(v, s=40)
        lg, caches = model.forward(tree, {"tokens": toks}, mode="prefill",
                                   caches=model.init_cache(
                                       2, RING_MAX_LEN, device="cpu"))
        out["prefill"] = lg.float().numpy()
        nxt = TPW.prompt(v, s=5, seed=4)
        for j in range(3):
            lg, caches = model.decode_step(tree, nxt[:, j:j + 1], caches)
            out[f"decode{j}"] = lg.float().numpy()
        lg, caches = model.prefill(tree, {"tokens": TPW.prompt(v, s=29,
                                                               seed=5)},
                                   model.init_cache(2, RING_MAX_LEN,
                                                    device="cpu"))
        out["prefill29"] = lg.float().numpy()
        for j in range(5):
            lg, caches = model.decode_step(tree, nxt[:, j:j + 1], caches)
            out[f"wrap_decode{j}"] = lg.float().numpy()
        toks = TPW.prompt(v, s=48, seed=6)
        caches = model.init_cache(2, RING_MAX_LEN, device="cpu")
        for i, (a, b) in enumerate(((0, 20), (20, 40), (40, 48))):
            lg, caches = model.prefill_chunk(tree,
                                             {"tokens": toks[:, a:b]},
                                             caches)
            out[f"chunk{i}"] = lg.float().numpy()
    return out, [r.numpy().copy() for r in log]


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def forward_ranks(tp, mla_names, ring_names):
    """The MLA cases ``mla_names`` (:func:`TPW.forward_suite`) and the ring
    cases ``ring_names`` (:func:`ring_suite`) on a ``(world / tp, tp)``
    ('data', 'model') mesh: each whole tree quantized over the group's
    ranks, cut by ``tp_local``, run under the mesh. Returns the rank's
    logits (and the ring's expert picks) by case, the MLA cache's and the
    ring's shapes, its local MLA shards' shapes, and what an int4 128-group
    cut of ``wo`` past :data:`W4G_MAX_TP` raised."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import activate_mesh, tp_local
    from repro_torch.launch.mesh import make_quantize_mesh
    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
           "mla": {}, "ring": {}, "routes": {}}
    for name in mla_names:
        model, whole = mla_case(name, qmesh)
        with activate_mesh(mesh):
            out["mla"][name] = TPW.forward_suite(
                model, tp_local(whole, mesh, model.cfg))
    for name in ring_names:
        model = ring_model()
        whole = quantized(params_of(model), RING_CASES[name], qmesh)
        with activate_mesh(mesh):
            out["ring"][name], out["routes"][name] = ring_suite(
                model, tp_local(whole, mesh, model.cfg))
    model, whole = mla_case("fp")
    local = tp_local(whole, mesh, model.cfg)
    out["mla_shapes"] = {k: tuple(v.shape) for k, v in TPW._leaves(
        local["stack"]["list"][0]["b0"]["attn"])}
    if tp > W4G_MAX_TP:
        try:
            m4, t4 = mla_case("w4_group_scales")
            tp_local(t4, mesh, m4.cfg)
        except ValueError as e:
            out["w4g_split_group"] = str(e)
    with activate_mesh(mesh):
        c = model.init_cache(2, 8, device="cpu")["list"][0]["b0"]
        out["mla_cache"] = {k: tuple(v.shape) for k, v in c.items()}
        c = ring_model().init_cache(2, RING_MAX_LEN, device="cpu")
        out["ring_cache"] = tuple(c["list"][0]["b0"]["k"].shape)
    return out


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

TRAIN_STEPS = 3
TRAIN_VOCAB = 64                 # 'model' 2 and 4 divide it: vocab-parallel
RING_SEQ = 48                    # past the 32-token window
# name -> (mesh shape, axis names)
TRAIN_CASES = {"data2_model2": ((2, 2), ("data", "model")),
               "data1_model4": ((1, 4), ("data", "model"))}


def train_model(kind):
    """The training cases' model: MLA at :data:`MLA_TINY`, or the ring at
    capacity factor :data:`BINDING_CF` (capacity binds, so routing the
    global batch and routing each data rank's slice differ), both at
    vocabulary :data:`TRAIN_VOCAB`."""
    if kind == "mla":
        return mla_model(vocab=TRAIN_VOCAB)
    return ring_model(BINDING_CF, vocab=TRAIN_VOCAB)


def train_batches(kind, n=TRAIN_STEPS):
    s = RING_SEQ if kind == "ring" else 16
    return TPW.train_batches(TRAIN_VOCAB, n, s=s)


def one_rank_train(kind, steps=TRAIN_STEPS):
    """The plain one-rank step's losses, grad norms and final params, and
    its gradients of the first batch."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model = train_model(kind)
    params = params_of(model)
    batches = [tl.to_device(b, "cpu") for b in train_batches(kind, steps)]
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


def _tp_train(kind, mesh):
    """The tensor-parallel step's averaged gradients of the first batch
    (``step.averaged_grads``, gathered whole), then its losses, grad norms
    and this rank's final shards over :data:`TRAIN_STEPS` steps."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    import torch_ep_workers as EP
    model = train_model(kind)
    placed = tp_place(params_of(model), mesh, model.cfg)
    batches = [tl.to_device(b, "cpu") for b in train_batches(kind)]
    step = tl.make_train_step(model, AdamWConfig(**TPW._STEP), mesh=mesh)
    _, _, g = step.averaged_grads(placed, batches[0])
    grads = EP._np(EP._whole_grads(mesh, placed, g))
    opt = adamw_init(placed)
    losses, norms = [], []
    for b in batches:
        placed, opt, met = step(placed, opt, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, TPW._shards(placed), grads


def _pod_losses(mesh, steps, tp):
    """MLA's pod-compressed step on ``mesh`` (tensor-parallel when
    ``tp``): its losses over ``steps`` steps and whether the
    error-feedback buffers kept their logical shapes."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    model = train_model("mla")
    params = params_of(model)
    err = tl.init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    if tp:
        params = tp_place(params, mesh, model.cfg)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**TPW.POD_OPT),
                              pod_compress=True, mesh=mesh)
    losses = []
    for b in train_batches("mla", steps):
        params, opt, err, met = step(params, opt, err,
                                     tl.to_device(b, "cpu"))
        losses.append(float(met["loss"]))
    return {"losses": losses, "shapes_kept": [
        tuple(e.shape) for e in tree_leaves(err)] == shapes}


def train_ranks(kinds):
    """Every case of :data:`TRAIN_CASES` for each model of ``kinds``
    ("mla", "ring"); for MLA also the pod-compressed step on (pod 2, data
    1, model 2) beside the non-tensor-parallel pod step on (pod 2, data 1)
    (ranks 0 and 1)."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    torch.set_num_threads(1)
    out = {"rank": dist.get_rank(), "cases": {}}
    for kind in kinds:
        for name, (shape, axes) in TRAIN_CASES.items():
            out["cases"][f"{kind}_{name}"] = _tp_train(
                kind, make_mesh(shape, axes))
    if "mla" in kinds:
        out["pod_tp"] = _pod_losses(make_mesh((2, 1, 2), ("pod", "data",
                                                           "model")),
                                    TRAIN_STEPS, True)
        plain = make_mesh((2, 1), ("pod", "data"))
        if plain.get_coordinate() is not None:
            out["pod_plain"] = _pod_losses(plain, TRAIN_STEPS, False)
    dist.barrier()
    return out


def ranks_of(tp, mla_names, ring_names, kinds):
    """:func:`forward_ranks`, then :func:`train_ranks` of ``kinds``, in
    one set of rank processes."""
    out = forward_ranks(tp, mla_names, ring_names)
    out["train"] = train_ranks(kinds) if kinds else None
    return out


def mla_forward_one_rank(name):
    return TPW.forward_suite(*mla_case(name))


def ring_forward_one_rank(name):
    model = ring_model()
    return ring_suite(model, quantized(params_of(model), RING_CASES[name]))


# ---------------------------------------------------------------------------
# the reference's GSPMD forward and step
# ---------------------------------------------------------------------------

REF_OVER = dict(dtype="float32", n_layers=2, vocab=TRAIN_VOCAB)
REF_SEQ = {"mla": 16, "ring": RING_SEQ}


def reference_config(kind, jax=False):
    """The reference comparison's config: reduced minicpm3, or the ring
    (:func:`ring_config` at :data:`BINDING_CF`), at :data:`REF_OVER`; the
    port's or, with ``jax``, the reference's."""
    if kind == "ring":
        return ring_config(BINDING_CF, jax=jax, vocab=TRAIN_VOCAB)
    if jax:
        from repro.configs import get_config
    else:
        from repro_torch.configs import get_config
    return dataclasses.replace(get_config("minicpm3-4b", reduced=True),
                               **REF_OVER)


def reference_params(kind, path):
    """The reference's ``init`` (key 0) of ``kind``'s config, carried over
    to the port and saved at ``path``: the reference's params."""
    import jax
    from repro.models.model import build_model
    from repro_torch import convert
    jparams = build_model(reference_config(kind, jax=True)).init(
        jax.random.PRNGKey(0))
    torch.save(convert.from_jax_params(jax.device_get(jparams),
                                       device="cpu"), path)
    return jparams


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
