"""Rank code of the tensor-parallel tests: module-level functions that
``distributed.group.run_local`` runs in gloo rank processes on the CPU
(the tests' directory is on the children's path), and the one-rank
forward the tests hold them against. Everything returned is host data.

The model is granite's dense GQA stack at test widths: d_model 128, 8 q /
4 KV heads of 32, d_ff 512, 2 layers, float32 unless a case says
otherwise, so 'model' axes of 2 and 4 divide every sharded dim and an
int4 128-group shard of ``wo``/``wdown`` at 'model' 2 holds whole groups.
"""
import dataclasses
import os

import numpy as np
import torch

TP_TINY = dict(dtype="float32", n_layers=2, d_model=128, n_heads=8,
               n_kv_heads=4, head_dim=32, d_ff=512)

# name -> (config overrides, (bits, group_size[, form]) or None for fp
# weights): SQuant trees of ``quantize_tree`` (its 128-groups are the
# flip's, its scales per channel), the same codes in the checkpointable
# ``w_q`` / ``w_q4`` / ``w_scale`` form (form "serving"), or
# ``group_scale_tree``'s int4 codes under one scale per 128-group (form
# "group_scales"), the per-group option kernel B takes
FORWARD_CASES = {
    "tied_v256_fp": (dict(vocab=256, tie_embeddings=True), None),
    "tied_v256_w8": (dict(vocab=256, tie_embeddings=True), (8, None)),
    "untied_v257_fp": (dict(vocab=257, tie_embeddings=False), None),
    "untied_v257_w8": (dict(vocab=257, tie_embeddings=False), (8, None)),
    "untied_v256_w8": (dict(vocab=256, tie_embeddings=False), (8, None)),
    "untied_v256_w4g": (dict(vocab=256, tie_embeddings=False), (4, 128)),
    "tied_v257_w4g": (dict(vocab=257, tie_embeddings=True), (4, 128)),
    "gemma_qknorm_geglu_fp": (dict(vocab=256, qk_norm=True,
                                   ffn_kind="geglu", norm_plus_one=True,
                                   emb_scale=True), None),
    "bf16_w8": (dict(vocab=256, dtype="bfloat16"), (8, None)),
    "untied_v256_w4_serving": (dict(vocab=256, tie_embeddings=False),
                               (4, 128, "serving")),
    "untied_v256_w4_group_scales": (dict(vocab=256, tie_embeddings=False),
                                    (4, 128, "group_scales")),
    "tied_v257_w4_group_scales": (dict(vocab=257, tie_embeddings=True),
                                  (4, 128, "group_scales")),
}
W4G_MAX_TP = 2        # wo's 256 input columns hold whole 128-groups up to 2


def group_scale_tree(params, bits, group_size):
    """Every dense kernel ``{"w": (in, out)}`` of ``params`` as a
    ``QuantizedTensor`` of round-to-nearest codes under one max scale per
    ``group_size`` input columns of each output row (``(out, in /
    group_size)``); other leaves as they are."""
    from repro_torch.quant.qtypes import from_codes, qmax_for_bits
    from repro_torch.quant.scales import compute_scale

    def one(node):
        if isinstance(node, dict):
            if isinstance(node.get("w"), torch.Tensor) and \
                    node["w"].ndim == 2:
                w = node["w"].T.contiguous().to(torch.float32)
                sc = compute_scale(w, bits, group_size=group_size)
                q = qmax_for_bits(bits)
                codes = torch.clamp(torch.round(
                    w / sc.repeat_interleave(group_size, dim=1)), -q, q)
                return dict(node, w=from_codes(codes.to(torch.int8), sc,
                                               bits, group_size))
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, list):
            return [one(v) for v in node]
        return node
    return one(params)


def tiny_model(seed=0, **over):
    """granite at :data:`TP_TINY` (and ``over``), params from ``seed`` on
    the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              **dict(TP_TINY, **over))
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(seed),
                             device="cpu")


def case_tree(name, mesh=None):
    """The case's model and whole weight tree: fp, or quantized by
    ``quantize_tree`` (over ``mesh``'s ranks, row slabs, then gathered,
    where a quantize mesh is given)."""
    from repro_torch.core import pipeline
    from repro_torch.distributed.sharding import gather_tree
    over, quant = FORWARD_CASES[name]
    model, params = tiny_model(**over)
    if quant is None:
        return model, params
    bits, gs = quant[:2]
    if quant[2:] == ("group_scales",):
        return model, group_scale_tree(params, bits, gs)
    if quant[2:] == ("serving",):
        from repro_torch.quant.apply import quantize_params_serving
        return model, quantize_params_serving(params, bits, "squant", gs)[0]
    tree, _ = pipeline.quantize_tree(params, method="squant", bits=bits,
                                     group_size=gs, device="cpu", mesh=mesh)
    return model, gather_tree(tree) if mesh is not None else tree


def prompt(vocab, b=2, s=12, seed=3):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, size=(b, s)))


def forward_suite(model, tree):
    """Float32 numpy logits of a prefill, a chunked prefill (8 + 4 rows)
    and three decode steps after the prefill, on a contiguous cache; run
    under whatever mesh is active."""
    toks = prompt(model.cfg.vocab)
    b, s = toks.shape
    out = {}
    logits, caches = model.forward(tree, {"tokens": toks}, mode="prefill",
                                   caches=model.init_cache(b, 32,
                                                           device="cpu"))
    out["prefill"] = logits.float().numpy()
    nxt = prompt(model.cfg.vocab, s=3, seed=4)
    for j in range(3):
        lg, caches = model.decode_step(tree, nxt[:, j:j + 1], caches)
        out[f"decode{j}"] = lg.float().numpy()
    caches = model.init_cache(b, 32, device="cpu")
    lg, caches = model.prefill_chunk(tree, {"tokens": toks[:, :8]}, caches)
    out["chunk0"] = lg.float().numpy()
    lg, caches = model.prefill_chunk(tree, {"tokens": toks[:, 8:]}, caches)
    out["chunk1"] = lg.float().numpy()
    return out


QUANT_PATHS = (("stack", "list", "0", "b0", "attn", "wq", "w"),
               ("stack", "list", "0", "b0", "attn", "wo", "w"),
               ("stack", "list", "1", "b0", "ffn", "wdown", "w"),
               ("stack", "list", "1", "b0", "ffn", "wg", "w"),
               ("lm_head", "w"))


def _at(tree, path):
    """The node at ``path`` (None where a key is missing)."""
    for k in path:
        if isinstance(tree, list):
            tree = tree[int(k)]
        elif k in tree:
            tree = tree[k]
        else:
            return None
    return tree


def forward_ranks(tp, names):
    """Every case of :data:`FORWARD_CASES` (w4 per-group up to
    :data:`W4G_MAX_TP`) on a ``(world / tp, tp)`` ('data', 'model') mesh
    of the group: the whole tree quantized over the group's ranks, turned
    into this rank's local tree, the suite run under the mesh. Returns
    the rank's logits by case, its local codes and scales of
    :data:`QUANT_PATHS`, and what the out-of-scope forward modes raised."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import activate_mesh, tp_local
    from repro_torch.launch.mesh import make_quantize_mesh
    torch.set_num_threads(1)
    world = dist.get_world_size()
    mesh = make_mesh((world // tp, tp), ("data", "model"))
    qmesh = make_quantize_mesh(world)
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
           "logits": {}, "quant": {}}
    for name in names:
        model, whole = case_tree(name, qmesh)
        local = tp_local(whole, mesh)
        with activate_mesh(mesh):
            out["logits"][name] = forward_suite(model, local)
        if FORWARD_CASES[name][1] not in (None, (4, 128, "serving")):
            out["quant"][name] = {
                "/".join(p): (qt.data.numpy(), qt.scale.numpy(), qt.shape)
                for p in QUANT_PATHS if (qt := _at(local, p)) is not None}
    raised = {}
    if tp > W4G_MAX_TP:             # a shard of wo would split a 128-group
        try:
            tp_local(case_tree("untied_v256_w4_group_scales")[1], mesh)
        except ValueError as e:
            raised["w4g_split_group"] = str(e)
    model, whole = case_tree("tied_v256_fp")
    local = tp_local(whole, mesh)
    with activate_mesh(mesh):
        caches = model.init_cache(2, 32, device="cpu")
        caches["pos"] = torch.zeros(2, dtype=torch.int64)
        for mode in ("verify",):
            try:
                model.forward(local, {"tokens": prompt(256, s=2)},
                              mode=mode, caches=caches)
            except NotImplementedError as e:
                raised[mode] = str(e)
        caches["block_tables"] = torch.zeros((2, 2), dtype=torch.int32)
        try:
            model.forward(local, {"tokens": prompt(256, s=1)},
                          mode="decode", caches=caches)
        except NotImplementedError as e:
            raised["paged_decode"] = str(e)
    out["raised"] = raised
    with activate_mesh(mesh):
        out["cache_k_shape"] = tuple(
            model.init_cache(1, 4, device="cpu")["list"][0]["b0"]["k"]
            .shape)
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_OVER = dict(vocab=64)      # 'model' 2 and 4 divide it: vocab-parallel
TRAIN_STEPS = 3
POD_STEPS = 60


def train_batches(vocab, n, b=8, s=16, seed=1):
    from repro_torch.data.synthetic import markov_batches
    return [bt for bt, _ in zip(markov_batches(b, s, vocab, seed=seed),
                                range(n))]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _shards(tree):
    """``{path: (local numpy, slices)}`` of a DTensor tree on this rank."""
    from repro_torch.distributed.sharding import shard_index
    out = {}
    for k, t in _leaves(tree):
        idx = shard_index(t.shape, t.placements, tuple(t.device_mesh.shape),
                          t.device_mesh.get_coordinate())
        out[k] = (t.to_local().detach().numpy().copy(),
                  tuple((s.start, s.stop) for s in idx))
    return out


def one_rank_train(ocfg, steps, clip=None, over=TRAIN_OVER):
    """The plain one-rank step's losses, grad norms and final params."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model, params = tiny_model(**over)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**ocfg))
    losses, norms = [], []
    for b in train_batches(model.cfg.vocab, steps):
        params, opt, met = step(params, opt, tl.to_device(b, "cpu"))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, {k: v.detach().numpy() for k, v in
                           _leaves(params)}


# AdamW's update g / (|g| + eps) moves by up to lr * dg / eps when a
# gradient element moves by dg, most where |g| is near zero. Two summation
# orders of the same gradient (one rank's products, or partial sums over
# 'model') differ by dg up to ~2e-7 here (the embedding's; the gradients
# themselves are held at GRAD_TOL), so at the default eps of 1e-8 the few
# elements with |g| below 1e-7 take updates up to lr / 10 apart. A gate on
# the parameters at STEP_TOL (~1e-6 here) needs lr * dg / eps below it:
# the step cases run eps 1e-3 (the typical |g| is 1e-3)
_STEP = dict(lr=3e-3, warmup_steps=0, decay_steps=10, eps=1e-3)
TRAIN_CASES = {     # name -> (mesh shape, axis names, AdamW overrides)
    "data2_model2": ((2, 2), ("data", "model"), _STEP),
    "data2_model2_clip": ((2, 2), ("data", "model"),
                          dict(_STEP, clip_norm=0.05)),
    "data1_model4": ((1, 4), ("data", "model"), _STEP),
}
POD_OPT = dict(lr=3e-3, warmup_steps=0, decay_steps=100)


def one_rank_grads(over=TRAIN_OVER):
    """The one-rank gradients of the first training batch."""
    from repro_torch.training import train_loop as tl
    model, params = tiny_model(**over)
    batch = tl.to_device(train_batches(model.cfg.vocab, 1)[0], "cpu")
    _, _, g = tl._value_and_grad(model.train_loss, params, batch)
    return {k: v.numpy() for k, v in _leaves(g)}


def averaged_grads(model, mesh, placed, batch):
    """The loss and whole gradients of ``batch`` that the tensor-parallel
    step on ``mesh`` updates with, from public pieces: this rank's slice
    of the batch over 'data' through ``model.train_loss`` on its shards
    under the mesh, the loss and shard gradients averaged over 'data',
    and the shards gathered."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import group as dgroup
    from repro_torch.distributed.sharding import activate_mesh, gather_tree
    from repro_torch.training.optimizer import tree_leaves, tree_map
    n = mesh.shape[mesh.mesh_dim_names.index("data")]
    k = mesh.get_local_rank("data")
    per = next(iter(batch.values())).shape[0] // n
    mine = {key: v[k * per:(k + 1) * per] for key, v in batch.items()}
    local = tree_map(lambda t: t.to_local().detach().requires_grad_(True),
                     placed)
    leaves = tree_leaves(local)
    with torch.enable_grad(), activate_mesh(mesh):
        loss, _ = model.train_loss(local, mine)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(leaves, gs)}

    def mean(t):
        if n == 1:
            return t
        return dgroup.all_reduce(t.clone(), mesh.get_group("data")) / n

    grads = tree_map(lambda p, t: DTensor.from_local(
        mean(by_leaf[id(p)]), mesh, t.placements, run_check=False,
        shape=t.shape, stride=t.stride()), local, placed)
    return float(mean(loss.detach())), gather_tree(grads)


def _tp_train(mesh, ocfg, steps, over=TRAIN_OVER):
    """The tensor-parallel step's losses, grad norms and final shards, and
    its averaged gradients of the first batch, gathered."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model, params = tiny_model(**over)
    placed = tp_place(params, mesh)
    opt = adamw_init(placed)
    step = tl.make_train_step(model, AdamWConfig(**ocfg), mesh=mesh)
    _, grads = averaged_grads(model, mesh, placed, tl.to_device(
        train_batches(model.cfg.vocab, 1)[0], "cpu"))
    grads = {k: v.numpy() for k, v in _leaves(grads)}
    losses, norms = [], []
    for b in train_batches(model.cfg.vocab, steps):
        placed, opt, met = step(placed, opt, tl.to_device(b, "cpu"))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, _shards(placed), grads


def _pod_run(mesh, steps, tp):
    """The pod-compressed step on ``mesh`` (tensor-parallel when ``tp``):
    its losses, the error buffers' leaf order and shapes, and this rank's
    pod and its error-feedback row after the first step."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    model, params = tiny_model(**TRAIN_OVER)
    err = tl.init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    if tp:
        params = tp_place(params, mesh)
    opt = adamw_init(params)
    step = tl.make_train_step(model, AdamWConfig(**POD_OPT),
                              pod_compress=True, mesh=mesh)
    pod = mesh.get_local_rank("pod")
    losses, first = [], None
    for b in train_batches(model.cfg.vocab, steps):
        params, opt, err, met = step(params, opt, err,
                                     tl.to_device(b, "cpu"))
        losses.append(float(met["loss"]))
        if first is None:
            first = {k: v[pod].numpy().copy() for k, v in _leaves(err)}
    assert [tuple(e.shape) for e in tree_leaves(err)] == shapes
    return {"losses": losses, "pod": pod, "err_first": first,
            "err": [(k, tuple(v.shape)) for k, v in _leaves(err)]}


def pod_block_scales(pod, n_pods=2):
    """The int8 block scales (``grad_compression.BLOCK`` elements each) of
    pod ``pod``'s logical gradient of the first training batch, from the
    one-rank gradient of the pod's slice of it: what the pod-compressed
    step's first error-feedback row is quantized under."""
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import tree_map
    model, params = tiny_model(**TRAIN_OVER)
    b = tl.to_device(train_batches(model.cfg.vocab, 1)[0], "cpu")
    per = next(iter(b.values())).shape[0] // n_pods
    mine = {k: v[pod * per:(pod + 1) * per] for k, v in b.items()}
    _, _, g = tl._value_and_grad(model.train_loss, params, mine)
    flat, _ = gc.compress_local(g, tree_map(torch.zeros_like, g))
    return (flat.reshape(-1, gc.BLOCK).abs().amax(1) / 127).numpy()


def _trainer_run(mesh, ckpt, total, steps_before=None):
    """A ``Trainer`` on ``mesh`` to ``total`` steps (stopped after
    ``steps_before`` first and started again, where given): the losses."""
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig
    model, params = tiny_model(**TRAIN_OVER)
    ocfg = AdamWConfig(**POD_OPT)
    history = []
    for stop in ([steps_before] if steps_before else []) + [total]:
        step = tl.make_train_step(model, ocfg, mesh=mesh)
        trainer = tl.Trainer(model, ocfg, tl.TrainerConfig(
            total_steps=stop, checkpoint_every=2, checkpoint_dir=ckpt,
            async_checkpoint=False, log_every=100), train_step=step,
            device="cpu")
        data = iter(train_batches(model.cfg.vocab, total)[len(history):])
        _, _, info = trainer.run(tp_place(params, mesh), data)
        history += info["history"]
    return history


def train_ranks(ckpt_dir):
    """The training cases on four gloo ranks: :data:`TRAIN_CASES`; the
    pod-compressed step on (pod 2, data 1, model 2) for :data:`POD_STEPS`
    steps and for :data:`TRAIN_STEPS` beside the non-tensor-parallel pod
    step on (pod 2, data 1) (ranks 0 and 1); a ``Trainer`` on (data 1,
    model 2) (ranks 0 and 1) run through and stopped then resumed; and
    the FSDP placement the step refuses."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import reshard_serving_tree
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank, "cases": {}}
    for name, (shape, names, ocfg) in TRAIN_CASES.items():
        mesh = make_mesh(shape, names)
        out["cases"][name] = _tp_train(mesh, ocfg, TRAIN_STEPS)
    pod_mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    out["pod_learn"] = _pod_run(pod_mesh, POD_STEPS, True)["losses"]
    out["pod_tp"] = _pod_run(pod_mesh, TRAIN_STEPS, True)
    plain_pod = make_mesh((2, 1), ("pod", "data"))
    if plain_pod.get_coordinate() is not None:
        out["pod_plain"] = _pod_run(plain_pod, TRAIN_STEPS, False)
    tp2 = make_mesh((1, 2), ("data", "model"))
    if tp2.get_coordinate() is not None:
        out["trainer_through"] = _trainer_run(
            tp2, os.path.join(ckpt_dir, "through"), 4)
        out["trainer_resumed"] = _trainer_run(
            tp2, os.path.join(ckpt_dir, "resumed"), 4, steps_before=2)
    # a tree placed by the full rules (FSDP over 'data') is refused
    mesh = make_mesh((2, 2), ("data", "model"))
    model, params = tiny_model(**TRAIN_OVER)
    fsdp = reshard_serving_tree(params, mesh)
    step = tl.make_train_step(model, AdamWConfig(), mesh=mesh)
    try:
        step(fsdp, adamw_init(fsdp),
             tl.to_device(train_batches(64, 1)[0], "cpu"))
    except NotImplementedError as e:
        out["fsdp_raised"] = str(e)
    dist.barrier()
    return out


def mesh_option_ranks():
    """A 'model' 2 step on two ranks through both mesh options: (data 1,
    model 2), and (pod 1, data 1, model 2) with ``pod_compress`` (no 'pod'
    axis of 2 to compress over: the plain tensor-parallel step). Their
    losses and grad norms over :data:`TRAIN_STEPS` steps."""
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import tp_place
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    out = []
    for shape, names, pod in (((1, 2), ("data", "model"), False),
                              ((1, 1, 2), ("pod", "data", "model"), True)):
        mesh = make_mesh(shape, names)
        model, params = tiny_model(**TRAIN_OVER)
        placed = tp_place(params, mesh)
        opt = adamw_init(placed)
        step = tl.make_train_step(model, AdamWConfig(**_STEP),
                                  pod_compress=pod, mesh=mesh)
        met = []
        for b in train_batches(model.cfg.vocab, TRAIN_STEPS):
            placed, opt, m = step(placed, opt, tl.to_device(b, "cpu"))
            met.append((float(m["loss"]), float(m["grad_norm"])))
        out.append(met)
    return out


def reference_ranks(params_path, tokens, batch):
    """The port's side of the reference comparison on (data 2, model 2):
    prefill logits of ``tokens`` on the TP-local tree, and the averaged
    loss and gradients of ``batch`` and one step's metrics (a DTensor tree
    gathered) from ``tp_place``'s, as rank 0 holds them."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (activate_mesh, tp_local,
                                                  tp_place)
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    torch.set_num_threads(1)
    model, _ = tiny_model(**TRAIN_OVER)
    params = torch.load(params_path)
    mesh = make_mesh((2, 2), ("data", "model"))
    toks = torch.from_numpy(tokens)
    with activate_mesh(mesh):
        logits, _ = model.forward(
            tp_local(params, mesh), {"tokens": toks}, mode="prefill",
            caches=model.init_cache(toks.shape[0], toks.shape[1],
                                    device="cpu"))
    placed = tp_place(params, mesh)
    step = tl.make_train_step(model, AdamWConfig(), mesh=mesh)
    b = tl.to_device(batch, "cpu")
    loss, grads = averaged_grads(model, mesh, placed, b)
    grads = {k: v.numpy() for k, v in _leaves(grads)}
    _, _, met = step(placed, adamw_init(placed), b)
    out = {"logits": logits.numpy(), "loss": float(loss), "grads": grads,
           "step": {k: float(met[k]) for k in ("loss", "grad_norm")}}
    return out if dist.get_rank() == 0 else None
