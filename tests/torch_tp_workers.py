"""Rank code of the tensor-parallel tests: module-level functions that
``distributed.group.run_local`` runs in gloo rank processes on the CPU
(the tests' directory is on the children's path), and the one-rank
forward the tests hold them against. Everything returned is host data.

The model is granite's dense GQA stack at test widths: d_model 128, 8 q /
4 KV heads of 32, d_ff 512, 2 layers, float32 unless a case says
otherwise, so 'model' axes of 2 and 4 divide every sharded dim and an
int4 128-group shard of ``wo``/``wdown`` at 'model' 2 holds whole groups.
The cases of :data:`GROUP_CASES` (at 'model' 4 only) take heads or an FFN
width that 'model' 4 does not divide, on replica groups
(``sharding.replica_groups``): 8 q / 2 KV heads (two ranks share each KV
head), 6 q / 2 KV (two ranks share each q shard too), minicpm3's MLA with
6 heads, and ``d_ff`` 130. The cases of :data:`ENCDEC_CASES` run the
encoder-decoder (reduced seamless, 2 + 2 layers at d_model 128, 8 heads of
16, ``d_ff`` 256) at both sizes over random frames: its vocabulary of 258
= 2 x 129 is vocab-parallel at 'model' 2 and replicated at 4, as
seamless's 256 206 is at 2 and at 4, 8 and 16.
"""
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs.base import MLAConfig

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
GROUP_TP = 4          # the 'model' size the replica-group cases run at
MLA_H6 = dict(arch="minicpm3-4b", n_heads=6, n_kv_heads=6, d_ff=256,
              mla=MLAConfig(q_lora=128, kv_lora=128, nope_dim=16,
                            rope_dim=8, v_dim=32))
GROUP_CASES = {
    "q8_kv2_fp": (dict(vocab=256, n_kv_heads=2), None),
    "q6_kv2_w8": (dict(vocab=256, n_heads=6, n_kv_heads=2), (8, None)),
    "mla_h6_w8": (dict(MLA_H6, vocab=256), (8, None)),
    "dff130_fp": (dict(vocab=256, d_ff=130), None),
}
FORWARD_CASES.update(GROUP_CASES)
# the encoder-decoder: seamless's encoder and cross-attention under
# 'model' (its self-attention K/V at n_heads, as the full config's 16 / 16)
ENCDEC_OVER = dict(arch="seamless-m4t-medium", n_heads=8, n_kv_heads=8,
                   head_dim=16, d_ff=256, vocab=258)
ENCDEC_CASES = {"encdec_fp": (ENCDEC_OVER, None),
                "encdec_w8": (ENCDEC_OVER, (8, None))}
FORWARD_CASES.update(ENCDEC_CASES)


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


def tiny_model(seed=0, arch="granite-3-8b", **over):
    """``arch`` (granite) at :data:`TP_TINY` (and ``over``), params from
    ``seed`` on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config(arch, reduced=True),
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


def frames(cfg, b, t, seed=5):
    """Random float32 encoder frames ``(b, t, d_model)``."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (b, t, cfg.d_model)).astype(np.float32))


def forward_suite(model, tree):
    """Float32 numpy logits of a prefill, a chunked prefill (8 + 4 rows)
    and three decode steps after the prefill, on a contiguous cache; run
    under whatever mesh is active. An encoder-decoder's prefill and first
    chunk encode random frames, its second chunk and the decode steps
    attend the cache's encoder output (also returned, as ``enc_out``):
    the reference's forward modes (its ``prefill_chunk`` takes no
    encoder-decoder)."""
    toks = prompt(model.cfg.vocab)
    b, s = toks.shape
    encdec = model.cfg.is_encdec
    enc = {"enc_frames": frames(model.cfg, b, 6)} if encdec else {}
    out = {}
    logits, caches = model.forward(tree, {"tokens": toks, **enc},
                                   mode="prefill",
                                   caches=model.init_cache(b, 32,
                                                           device="cpu"))
    out["prefill"] = logits.float().numpy()
    if encdec:
        out["enc_out"] = caches["enc_out"].float().numpy()
    nxt = prompt(model.cfg.vocab, s=3, seed=4)
    for j in range(3):
        lg, caches = model.decode_step(tree, nxt[:, j:j + 1], caches)
        out[f"decode{j}"] = lg.float().numpy()
    caches = model.init_cache(b, 32, device="cpu")
    for j, part in enumerate((toks[:, :8], toks[:, 8:])):
        if encdec:
            batch = dict(enc) if j == 0 else {"enc_out": caches["enc_out"]}
            lg, caches = model.forward(tree, dict(batch, tokens=part),
                                       mode="chunk", caches=caches)
            lg = lg[:, -1]
        else:
            lg, caches = model.prefill_chunk(tree, {"tokens": part}, caches)
        out[f"chunk{j}"] = lg.float().numpy()
    return out


QUANT_PATHS = (("stack", "list", "0", "b0", "attn", "wq", "w"),
               ("stack", "list", "0", "b0", "attn", "wo", "w"),
               ("stack", "list", "1", "b0", "ffn", "wdown", "w"),
               ("stack", "list", "1", "b0", "ffn", "wg", "w"),
               ("lm_head", "w"),
               # the encoder-decoder's cross-attention and encoder
               ("stack", "list", "1", "b0", "xattn", "wv", "w"),
               ("stack", "list", "0", "b0", "xattn", "wo", "w"),
               ("encoder", "layers", "0", "attn", "wk", "w"),
               ("encoder", "layers", "1", "ffn", "wi", "w"),
               ("encoder", "layers", "1", "ffn", "wdown", "w"))


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
        local = tp_local(whole, mesh, cfg=model.cfg)
        with activate_mesh(mesh):
            out["logits"][name] = forward_suite(model, local)
        if FORWARD_CASES[name][1] not in (None, (4, 128, "serving")):
            out["quant"][name] = {
                "/".join(p): (qt.data.numpy(), qt.scale.numpy(), qt.shape)
                for p in QUANT_PATHS if (qt := _at(local, p)) is not None}
    raised = {}
    if tp > W4G_MAX_TP:             # a shard of wo would split a 128-group
        try:
            m4, t4 = case_tree("untied_v256_w4_group_scales")
            tp_local(t4, mesh, m4.cfg)
        except ValueError as e:
            raised["w4g_split_group"] = str(e)
    model, whole = case_tree("tied_v256_fp")
    local = tp_local(whole, mesh, model.cfg)
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
        out["group_cache_k_shape"] = {
            n: tuple(tiny_model(**GROUP_CASES[n][0])[0].init_cache(
                1, 4, device="cpu")["list"][0]["b0"]["k"].shape)
            for n in names if n in GROUP_CASES and "mla" not in
            GROUP_CASES[n][0]}
        cache = tiny_model(**ENCDEC_OVER)[0].init_cache(1, 8, device="cpu")
        out["encdec_cache_shapes"] = (tuple(cache["list"][0]["b0"]["k"].shape),
                                      tuple(cache["enc_out"].shape))
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_OVER = dict(vocab=64)      # 'model' 2 and 4 divide it: vocab-parallel
TRAIN_STEPS = 3
POD_STEPS = 60


def train_batches(vocab, n, b=8, s=16, seed=1, cfg=None):
    """``n`` synthetic batches (numpy tokens and labels); an
    encoder-decoder ``cfg``'s also carry random ``enc_frames`` of ``s /
    4`` frames."""
    from repro_torch.data.synthetic import markov_batches
    out = [bt for bt, _ in zip(markov_batches(b, s, vocab, seed=seed),
                               range(n))]
    if cfg is not None and cfg.is_encdec:
        for i, bt in enumerate(out):
            bt["enc_frames"] = frames(cfg, b, s // 4, seed=seed + i).numpy()
    return out


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
    for b in train_batches(model.cfg.vocab, steps, cfg=model.cfg):
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
# replica groups at 'model' 4 (config overrides): two ranks share each KV
# head (their partial K/V gradients summed), and two ranks share each q
# shard and each of d_ff 130's two FFN shards (one of them adds zeros)
GROUP_TRAIN_OVER = {
    "data1_model4_q8_kv2": dict(TRAIN_OVER, n_kv_heads=2),
    "data1_model4_q6_kv2_dff130": dict(TRAIN_OVER, n_heads=6, n_kv_heads=2,
                                       d_ff=130),
    # the encoder-decoder, its vocabulary 66 = 2 x 33 vocab-parallel at
    # 'model' 2 and replicated at 4, remat on (each encoder layer and
    # decoder block recomputed under the mesh)
    "encdec_data2_model2": dict(ENCDEC_OVER, vocab=66),
    "encdec_data1_model4": dict(ENCDEC_OVER, vocab=66),
}
TRAIN_CASES.update({n: ((2, 2) if "data2" in n else (1, 4),
                        ("data", "model"), _STEP)
                    for n in GROUP_TRAIN_OVER})
# the pod step's replica groups at 'model' 2: one KV head and d_ff 129,
# each whole on both ranks
POD_GROUP_OVER = dict(TRAIN_OVER, n_kv_heads=1, d_ff=129)
POD_OPT = dict(lr=3e-3, warmup_steps=0, decay_steps=100)
# FSDP (ZeRO-3) over 'data' (``sharding.fsdp_place``), cases named
# "fsdp_...": on (data 2, model 2), also with the clip active; pure ZeRO-3
# on (data 4, model 1); replica groups at 'model' 2 (one KV head, d_ff
# 129, whole on both 'model' ranks and cut over 'data'); the
# encoder-decoder
FSDP_TRAIN_OVER = {"fsdp_data2_model2": TRAIN_OVER,
                   "fsdp_data2_model2_clip": TRAIN_OVER,
                   "fsdp_data4_model1": TRAIN_OVER,
                   "fsdp_data2_model2_groups": POD_GROUP_OVER,
                   "fsdp_encdec_data2_model2":
                       GROUP_TRAIN_OVER["encdec_data2_model2"]}
TRAIN_CASES.update({n: ((4, 1) if "data4" in n else (2, 2),
                        ("data", "model"),
                        dict(_STEP, clip_norm=0.05) if "clip" in n else _STEP)
                    for n in FSDP_TRAIN_OVER})


def train_over(name):
    """The config overrides of training case ``name``."""
    return {**GROUP_TRAIN_OVER, **FSDP_TRAIN_OVER}.get(name, TRAIN_OVER)


def layout_of(name):
    """The parameter layout of training case ``name`` (:func:`placed_tree`)."""
    return "fsdp" if name.startswith("fsdp_") else "tp"


def one_rank_grads(over=TRAIN_OVER):
    """The one-rank gradients of the first training batch."""
    from repro_torch.training import train_loop as tl
    model, params = tiny_model(**over)
    batch = tl.to_device(train_batches(model.cfg.vocab, 1, cfg=model.cfg)[0],
                         "cpu")
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


def placed_tree(params, mesh, cfg, layout="tp"):
    """``params`` placed on ``mesh``: ``tp_place``'s replicated-over-'data'
    layout ("tp"), ``fsdp_place``'s FSDP layout ("fsdp"), or the rules'
    own (``reshard_serving_tree``, "rules": the dense model's FSDP
    layout)."""
    from repro_torch.distributed import sharding
    if layout == "rules":
        return sharding.reshard_serving_tree(params, mesh)
    place = sharding.fsdp_place if layout == "fsdp" else sharding.tp_place
    return place(params, mesh, cfg)


def _tp_train(mesh, ocfg, steps, over=TRAIN_OVER, layout="tp"):
    """The tensor-parallel (or, by ``layout``, FSDP) step's losses, grad
    norms and final shards, and its averaged gradients of the first batch,
    gathered: from public pieces for the "tp" layout
    (:func:`averaged_grads`), else ``step.averaged_grads``."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    model, params = tiny_model(**over)
    placed = placed_tree(params, mesh, model.cfg, layout)
    opt = adamw_init(placed)
    step = tl.make_train_step(model, AdamWConfig(**ocfg), mesh=mesh)
    first = tl.to_device(train_batches(model.cfg.vocab, 1, cfg=model.cfg)[0],
                         "cpu")
    if layout == "tp":
        _, grads = averaged_grads(model, mesh, placed, first)
    else:
        import torch_ep_workers as EP
        grads = EP._whole_grads(mesh, placed,
                                step.averaged_grads(placed, first)[2])
    grads = {k: v.numpy() for k, v in _leaves(grads)}
    losses, norms = [], []
    for b in train_batches(model.cfg.vocab, steps, cfg=model.cfg):
        placed, opt, met = step(placed, opt, tl.to_device(b, "cpu"))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return losses, norms, _shards(placed), grads


def _pod_run(mesh, steps, tp, over=TRAIN_OVER, layout="tp"):
    """The pod-compressed step on ``mesh`` (its params placed by
    :func:`placed_tree`'s ``layout`` when ``tp``, else plain tensors): its
    losses, the error buffers' leaf order and shapes, and this rank's pod
    and its error-feedback row after the first step."""
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                                tree_leaves)
    model, params = tiny_model(**over)
    err = tl.init_pod_error(params, 2)
    shapes = [tuple(e.shape) for e in tree_leaves(err)]
    if tp:
        params = placed_tree(params, mesh, model.cfg, layout)
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


def _trainer_run(mesh, ckpt, total, steps_before=None, layout="tp"):
    """A ``Trainer`` on ``mesh`` (the params placed by :func:`placed_tree`'s
    ``layout``) to ``total`` steps (stopped after ``steps_before`` first
    and started again, where given): the losses."""
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
        _, _, info = trainer.run(placed_tree(params, mesh, model.cfg,
                                             layout), data)
        history += info["history"]
    return history


def _fsdp_checkpoint(ckpt):
    """The dense model's params and AdamW state ``fsdp_place``d on (data
    2, model 2), after one step (moments not zero), saved (collective),
    then restored with ``restore(shardings=)`` onto ``fsdp_place``'s
    layout on (data 1, model 2) (ranks 0 and 1) and onto one rank (rank
    0): each restored tree gathered whole, as numpy, beside the saved
    trees gathered whole; and the placements of ``wq`` on each mesh."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (fsdp_place, gather_tree,
                                                  shardings_of)
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    def np_tree(tree):
        return {k: v.detach().numpy().copy() for k, v in _leaves(tree)}

    def np_state(p, opt):
        return {"params": np_tree(gather_tree(p)),
                "m": np_tree(gather_tree(opt["m"])),
                "v": np_tree(gather_tree(opt["v"]))}

    wq = ("stack", "list", "0", "b0", "attn", "wq", "w")
    model, params = tiny_model(**TRAIN_OVER)
    mesh = make_mesh((2, 2), ("data", "model"))
    placed = fsdp_place(params, mesh, model.cfg)
    step = tl.make_train_step(model, AdamWConfig(**_STEP), mesh=mesh)
    placed, opt, _ = step(placed, adamw_init(placed), tl.to_device(
        train_batches(model.cfg.vocab, 1)[0], "cpu"))
    ck = Checkpointer(ckpt, async_save=False)
    ck.save(1, placed, opt)
    out = {"saved": np_state(placed, opt),
           "placements22": repr(_at(placed, wq).placements)}
    mesh2 = make_mesh((1, 2), ("data", "model"))
    if mesh2.get_coordinate() is not None:
        like = fsdp_place(params, mesh2, model.cfg)
        got, got_opt, _ = ck.restore(
            1, shardings=(shardings_of(like), shardings_of(
                adamw_init(like))), template=(like, adamw_init(like)),
            device="cpu")
        out["placements12"] = repr(_at(got, wq).placements)
        out["data1_model2"] = np_state(got, got_opt)
    dist.barrier()
    if dist.get_rank() == 0:
        one, one_opt, _ = ck.restore(
            1, template=(params, adamw_init(params)), device="cpu")
        out["one_rank"] = {"params": np_tree(one), "m": np_tree(one_opt["m"]),
                           "v": np_tree(one_opt["v"])}
    dist.barrier()
    return out


def fsdp_collectives(name):
    """One step of training case ``name`` (an FSDP one) from a fresh
    ``fsdp_place``: ``DATA_COLLECTIVES``' calls and bytes the step added,
    by kind, and what the layout implies for one gather of a period (or
    encoder layer) and of the embedding or head: the periods and layers
    with a 'data' shard, the tied or untied head, the 'data' size, and the
    padded bytes of each gather's shards (``group.gather_data``: 16-byte
    segments)."""
    from repro_torch.distributed import group as dgroup
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import data_shard
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    shape, axes, ocfg = TRAIN_CASES[name]
    mesh = make_mesh(shape, axes)
    model, params = tiny_model(**train_over(name))
    placed = placed_tree(params, mesh, model.cfg, "fsdp")
    step = tl.make_train_step(model, AdamWConfig(**ocfg), mesh=mesh)

    def units(tree):
        """Padded bytes and elements of the 'data'-sharded local shards of
        ``tree``."""
        mine = [t.to_local() for _, t in _leaves(tree)
                if data_shard(t) is not None]
        return (sum(-(-x.numel() * x.element_size() // 16) * 16
                    for x in mine), sum(x.numel() for x in mine))
    blocks = [units(p) for p in placed["stack"]["list"]]
    blocks += [units(p) for p in placed.get("encoder", {}).get("layers", [])]
    before = {k: dict(v) for k, v in dgroup.DATA_COLLECTIVES.items()}
    step(placed, adamw_init(placed), tl.to_device(
        train_batches(model.cfg.vocab, 1, cfg=model.cfg)[0], "cpu"))
    after = dgroup.DATA_COLLECTIVES
    return {"counted": {k: {c: after[k][c] - before[k][c]
                            for c in ("calls", "bytes")} for k in after},
            "data": shape[0], "blocks": blocks,
            "embedding": units(placed["embedding"]),
            "head": units(placed.get("lm_head", {})),
            "tied": model.cfg.tie_embeddings}


def _group_checkpoint(ckpt, name="data1_model4_q6_kv2_dff130"):
    """The model of :data:`GROUP_TRAIN_OVER`'s ``name`` (the 6 q / 2 KV,
    ``d_ff`` 130 one, or the encoder-decoder): its params and AdamW state
    ``tp_place``d on (data 1, model 4) (leaves cut by heads or FFN
    columns 4 does not divide whole on every rank, ``Replicate``) saved
    (collective), restored with
    ``restore(shardings=)`` onto (data 1, model 2) (ranks 0 and 1; saved
    again from there) and onto one rank (rank 0), then the 'model' 2 save
    restored onto 'model' 4: each restored tree gathered whole, as numpy,
    and the placements of ``wq`` on each mesh."""
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (gather_tree, shardings_of,
                                                  tp_place)
    from repro_torch.training.optimizer import adamw_init

    def np_tree(tree):
        return {k: v.detach().numpy().copy() for k, v in _leaves(tree)}

    def restore(ck, like):
        got, got_opt, _ = ck.restore(
            1, shardings=(shardings_of(like), shardings_of(
                adamw_init(like))), template=(like, adamw_init(like)),
            device="cpu")
        return got, got_opt

    wq = ("stack", "list", "0", "b0", "attn", "wq", "w")
    model, params = tiny_model(**GROUP_TRAIN_OVER[name])
    cfg = model.cfg
    mesh4 = make_mesh((1, 4), ("data", "model"))
    placed = tp_place(params, mesh4, cfg=cfg)
    ck4 = Checkpointer(os.path.join(ckpt, "4"), async_save=False)
    ck4.save(1, placed, adamw_init(placed))
    out = {"placements4": repr(_at(placed, wq).placements)}
    mesh2 = make_mesh((1, 2), ("data", "model"))
    ck2 = Checkpointer(os.path.join(ckpt, "2"), async_save=False)
    if mesh2.get_coordinate() is not None:
        got, got_opt = restore(ck4, tp_place(params, mesh2, cfg=cfg))
        out["placements2"] = repr(_at(got, wq).placements)
        out["model2"] = np_tree(gather_tree(got))
        out["model2_opt_m"] = np_tree(gather_tree(got_opt["m"]))
        ck2.save(1, got, got_opt)
    dist.barrier()
    if dist.get_rank() == 0:
        one, _, _ = ck4.restore(1, template=(params, adamw_init(params)),
                                device="cpu")
        out["one_rank"] = np_tree(one)
        out["saved"] = np_tree(params)
    back, _ = restore(ck2, placed)
    out["back4"] = np_tree(gather_tree(back))
    dist.barrier()
    return out


def train_ranks(ckpt_dir):
    """The training cases on four gloo ranks: :data:`TRAIN_CASES` (the
    FSDP ones from ``fsdp_place``); the rules' own FSDP layout
    (``reshard_serving_tree``) on (data 2, model 2); the replica-group
    model's and the encoder-decoder's checkpoints
    (:func:`_group_checkpoint`) and an FSDP one (:func:`_fsdp_checkpoint`);
    the pod-compressed step on (pod 2, data 1, model 2) for
    :data:`POD_STEPS` steps and for :data:`TRAIN_STEPS` beside the
    non-tensor-parallel pod step on (pod 2, data 1) (ranks 0 and 1), also
    at :data:`POD_GROUP_OVER`, and on (pod 2, data 2, model 1) FSDP-placed
    beside the same step replicated; a ``Trainer`` on (data 1, model 2)
    (ranks 0 and 1) and one FSDP-placed on (data 2, model 2), each run
    through and stopped then resumed; and each step's FSDP collectives
    (:func:`fsdp_collectives`)."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    from repro_torch.distributed.sharding import (fsdp_place,
                                                  shardings_of)
    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank, "cases": {}}
    for name, (shape, names, ocfg) in TRAIN_CASES.items():
        mesh = make_mesh(shape, names)
        out["cases"][name] = _tp_train(mesh, ocfg, TRAIN_STEPS,
                                       over=train_over(name),
                                       layout=layout_of(name))
    # the rules' own layout (the reference's make_param_shardings) of the
    # dense model is fsdp_place's, and trains
    mesh = make_mesh((2, 2), ("data", "model"))
    model, params = tiny_model(**TRAIN_OVER)
    out["rules_is_fsdp"] = all(
        (a.spec, a.split) == (b.spec, b.split) for a, b in zip(
            _leaves_of(shardings_of(placed_tree(params, mesh, model.cfg,
                                                "rules"))),
            _leaves_of(shardings_of(fsdp_place(params, mesh, model.cfg)))))
    out["rules"] = _tp_train(mesh, _STEP, TRAIN_STEPS, layout="rules")
    out["group_ckpt"] = _group_checkpoint(os.path.join(ckpt_dir, "group"))
    out["encdec_ckpt"] = _group_checkpoint(os.path.join(ckpt_dir, "encdec"),
                                           "encdec_data1_model4")
    out["fsdp_ckpt"] = _fsdp_checkpoint(os.path.join(ckpt_dir, "fsdp"))
    pod_mesh = make_mesh((2, 1, 2), ("pod", "data", "model"))
    out["pod_learn"] = _pod_run(pod_mesh, POD_STEPS, True)["losses"]
    out["pod_tp"] = _pod_run(pod_mesh, TRAIN_STEPS, True)
    out["pod_tp_group"] = _pod_run(pod_mesh, TRAIN_STEPS, True,
                                   over=POD_GROUP_OVER)
    pod22 = make_mesh((2, 2, 1), ("pod", "data", "model"))
    out["pod_fsdp"] = _pod_run(pod22, TRAIN_STEPS, True, layout="fsdp")
    out["pod_replicated"] = _pod_run(pod22, TRAIN_STEPS, False)
    plain_pod = make_mesh((2, 1), ("pod", "data"))
    if plain_pod.get_coordinate() is not None:
        out["pod_plain"] = _pod_run(plain_pod, TRAIN_STEPS, False)
        out["pod_plain_group"] = _pod_run(plain_pod, TRAIN_STEPS, False,
                                          over=POD_GROUP_OVER)
    tp2 = make_mesh((1, 2), ("data", "model"))
    if tp2.get_coordinate() is not None:
        out["trainer_through"] = _trainer_run(
            tp2, os.path.join(ckpt_dir, "through"), 4)
        out["trainer_resumed"] = _trainer_run(
            tp2, os.path.join(ckpt_dir, "resumed"), 4, steps_before=2)
    out["trainer_fsdp_through"] = _trainer_run(
        mesh, os.path.join(ckpt_dir, "fsdp_through"), 4, layout="fsdp")
    out["trainer_fsdp_resumed"] = _trainer_run(
        mesh, os.path.join(ckpt_dir, "fsdp_resumed"), 4, steps_before=2,
        layout="fsdp")
    out["collectives"] = {n: fsdp_collectives(n) for n in
                          ("fsdp_data2_model2", "fsdp_encdec_data2_model2")}
    dist.barrier()
    return out


def _leaves_of(tree):
    return [v for _, v in _leaves(tree)]


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
        placed = tp_place(params, mesh, model.cfg)
        opt = adamw_init(placed)
        step = tl.make_train_step(model, AdamWConfig(**_STEP),
                                  pod_compress=pod, mesh=mesh)
        met = []
        for b in train_batches(model.cfg.vocab, TRAIN_STEPS):
            placed, opt, m = step(placed, opt, tl.to_device(b, "cpu"))
            met.append((float(m["loss"]), float(m["grad_norm"])))
        out.append(met)
    return out


# the reference comparison's replica groups, on a (data 1, model 4) mesh
REF_GROUP_OVER = {"q8_kv2": dict(n_kv_heads=2),
                  "q6_kv2_dff130": dict(n_heads=6, n_kv_heads=2, d_ff=130)}
# the models the reference comparison runs on that mesh: the replica
# groups and the encoder-decoder (its vocabulary 66 replicated at 'model'
# 4, 2 of 8 heads a rank)
REF_MODEL4_OVER = dict(REF_GROUP_OVER,
                       encdec=dict(GROUP_TRAIN_OVER["encdec_data1_model4"]))


def _reference_side(model, params, mesh, tokens, batch, layouts=("tp",)):
    """Prefill logits of ``tokens`` (over ``batch``'s ``enc_frames``, an
    encoder-decoder's) on ``params``' TP-local tree under ``mesh``, and
    the averaged loss and gradients of ``batch`` and one step's metrics
    from its tree placed by each of ``layouts`` (:func:`placed_tree`;
    gathered): the first's at the top level, the others' under their
    names."""
    from repro_torch.distributed.sharding import activate_mesh, tp_local
    from repro_torch.training import train_loop as tl
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    toks = torch.from_numpy(tokens)
    inputs = {"tokens": toks}
    if "enc_frames" in batch:
        inputs["enc_frames"] = torch.from_numpy(batch["enc_frames"])
    with activate_mesh(mesh):
        logits, _ = model.forward(
            tp_local(params, mesh, cfg=model.cfg), inputs,
            mode="prefill", caches=model.init_cache(
                toks.shape[0], toks.shape[1], device="cpu"))
    out = {"logits": logits.numpy()}
    b = tl.to_device(batch, "cpu")
    for layout in layouts:
        placed = placed_tree(params, mesh, model.cfg, layout)
        step = tl.make_train_step(model, AdamWConfig(), mesh=mesh)
        if layout == "tp":
            loss, grads = averaged_grads(model, mesh, placed, b)
        else:
            import torch_ep_workers as EP
            loss, _, g = step.averaged_grads(placed, b)
            grads = EP._whole_grads(mesh, placed, g)
        _, _, met = step(placed, adamw_init(placed), b)
        side = {"loss": float(loss),
                "grads": {k: v.numpy() for k, v in _leaves(grads)},
                "step": {k: float(met[k]) for k in ("loss", "grad_norm")}}
        if layout == layouts[0]:
            out.update(side)
        else:
            out[layout] = side
    return out


def reference_ranks(params_path, tokens, batch, groups=None):
    """The port's side of the reference comparison on (data 2, model 2)
    (:func:`_reference_side`, the step from ``tp_place``'s,
    ``fsdp_place``'s and the rules' own layouts), and of each of
    ``groups`` (name -> (params path, tokens, batch):
    :data:`REF_MODEL4_OVER`'s models) on (data 1, model 4), as rank 0
    holds them."""
    import torch.distributed as dist
    from repro_torch.distributed.group import make_mesh
    torch.set_num_threads(1)
    model, _ = tiny_model(**TRAIN_OVER)
    out = _reference_side(model, torch.load(params_path),
                          make_mesh((2, 2), ("data", "model")), tokens,
                          batch, ("tp", "fsdp", "rules"))
    mesh = make_mesh((1, 4), ("data", "model"))
    out["groups"] = {}
    for name, (path, toks, b) in (groups or {}).items():
        model, _ = tiny_model(**dict(TRAIN_OVER, **REF_MODEL4_OVER[name]))
        out["groups"][name] = _reference_side(model, torch.load(path), mesh,
                                              toks, b)
    return out if dist.get_rank() == 0 else None


def reference_all_ranks(tp_args, moe_args, mr_args):
    """The port's sides of the reference comparison in one set of rank
    processes: :func:`reference_ranks` of ``tp_args``,
    ``torch_ep_workers.reference_moe_ranks`` of ``moe_args`` and
    ``torch_mla_ring_workers.reference_ranks`` of ``mr_args``, as rank 0
    holds them."""
    import torch.distributed as dist
    import torch_ep_workers as EP
    import torch_mla_ring_workers as MR
    out = (reference_ranks(*tp_args), EP.reference_moe_ranks(*moe_args),
           MR.reference_ranks(*mr_args))
    return out if dist.get_rank() == 0 else None
