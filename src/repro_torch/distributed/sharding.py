"""Logical-axis sharding: the single place where model dimensions meet mesh
axes.

Parameters get specs from name/shape rules (``make_param_shardings``); the
mapping logical→mesh lives in an ``AxisRules`` table so the same tree lays
out on one rank, a 256-rank pod, or the 512-rank 2-pod production mesh.

A spec is a tuple with one entry per tensor dim: ``None`` (replicated), a
mesh axis name, or a tuple of names (the dim split over several axes,
major to minor) — the entries of a JAX ``PartitionSpec``. ``to_placements``
turns one into DTensor placements on a ``DeviceMesh``; ``MeshSharding``
pairs a spec with its mesh (the reference's ``NamedSharding``).

Defaults implement the MaxText-standard regime for this scale:
* DP over ('pod', 'data')   — batch dim
* TP over 'model'           — heads / ff / vocab / experts
* FSDP (ZeRO-3) over 'data' — every parameter's non-TP dim
* SP over 'data'            — long-context KV/state sequence dim

Divisibility-aware: a dim is only assigned a mesh axis when the axis size
divides it (e.g. mixtral's 8 experts on a 16-way 'model' axis fall back to
FSDP-only and the expert ffn dim takes TP instead).

The rules take any mesh with axis names and sizes: a ``DeviceMesh``, or an
:class:`AbstractMesh` (names and sizes only, no ranks) to resolve specs
for a mesh larger than the group at hand. The reference drops the axes an
enclosing ``shard_map`` maps manually; the port has no ``shard_map``, so
every axis of the mesh is usable.

Tensor-parallel execution over 'model' (Megatron-style for the GQA and
MLA transformer, the encoder-decoder and the mamba and rwkv mixers,
expert-parallel for MoE):
:func:`activate_mesh` installs the mesh the forward runs on, and the
reference's activation constraints become the collectives GSPMD inserts
at the same points (:func:`shard_act`, :func:`to_model`,
:func:`shard_logits`: identities without an active mesh or with 'model'
1). Each rank computes on plain local tensors: :func:`tp_local` turns a
whole fp or quantized tree into this rank's shards (an MoE bank cut at
expert boundaries, the router whole), :func:`tp_place` a whole fp tree
into DTensors (what the train step and the checkpointer take). Only the
'model' entries of the rules apply, with two exceptions of mamba's
(``models.mamba``): ``x_proj`` is row-parallel over ``d_inner``, and
``in_proj``'s x and z halves are each cut on 'model' (a strided shard,
``MeshSharding.split``); and one of MoE's, below.

An expert count the 'model' axis does not divide takes the reference's
'expert_ff' fallback (:func:`expert_ff`): every rank holds every expert,
cut to its ``d_ff / tp`` FFN columns, ``wi`` / ``wg`` column-parallel
(the pipeline's ``(E·d_ff, d)`` codes a strided shard of split E: rank
``k`` holds rows ``e·d_ff + [k·d_ff/tp, (k+1)·d_ff/tp)`` of every expert
``e``) and ``wdown`` row-parallel (its ``d_ff`` input columns, at whole
groups), so each expert's product is a partial sum the block sums over
'model'. The reference's rule cuts ``wdown`` on its output dim ``d``
instead; the numbers are the same, the memory layout differs.

Heads and FFN widths the 'model' axis does not divide take replica groups
(:func:`replica_groups`): a count ``n`` (q heads, KV heads, FFN columns)
on a 'model' axis of ``tp`` is ``g = gcd(n, tp)`` contiguous shards, each
held by ``r = tp / g`` consecutive ranks (rank ``k`` holds shard ``k //
r``); ``r`` is 1, the plain cut, where ``tp`` divides ``n``. The shards
nest (``gcd(n_kv, tp)`` divides ``gcd(n_heads, tp)``), so a rank's q
heads lie over its KV shard's heads. Only the first rank of a q (or FFN)
replica group adds its row-parallel partial product; the others add exact
zeros (:func:`first_replica`). :func:`tp_local` cuts such a leaf to the
rank's group shard; :func:`tp_place` holds it
whole on every rank (``Replicate`` on 'model'), and the forward narrows it
through :func:`to_model` (:func:`group_slice`), so each use's gradient is
summed over 'model' once. The reference cuts the flattened ``heads ·
head_dim`` dim instead, inside a head, and reshards by GSPMD; its cache
rule puts 'model' on ``head_dim`` where the KV heads do not divide. The
numbers are the same; the memory layout differs.

MLA latent ranks, a mamba ``d_inner``, rwkv heads or an rwkv channel-mix
width that 'model' does not divide, an expert count and expert FFN width
it divides neither of, speculative verify and the paged KV layout raise
``NotImplementedError`` (:func:`check_tensor_parallel`).

FSDP (ZeRO-3) over 'data' for training: :func:`fsdp_place` places a
whole fp tree on the 'model' layout above plus the 'data' entries that
:func:`make_tp_shardings` leaves out (:func:`make_fsdp_shardings`): the
dim the reference's rule marks ``"fsdp"`` takes 'data' where 'data'
divides it. Where the port's 'model' layout already cuts that dim
(mamba's row-parallel ``x_proj``, the 'expert_ff' fallback's
row-parallel ``wdown``), 'data' goes on the leaf's other matrix dim
instead; the reference's rule would cut both on one dim. The numbers are
the same; the memory layout differs. Vectors and norm gains stay
replicated, and a quantized leaf keeps its 'model' layout. For the dense
GQA tree the layout is :func:`make_param_shardings`' own. The train step
installs an :class:`FsdpPlan` (:func:`activate_fsdp`) of the local
shards and the dims they cut; :func:`gather_params` gathers a period's
(or the embedding's, the head's) shards over 'data' where the forward
uses them (``group.gather_data``: one all-gather forward, one float32
reduce-scatter of the gradients backward).

MoE routing under data parallelism: the reference routes the global batch
(GSPMD), so a data-parallel step installs a :class:`RoutingGroup` of the
ranks whose tokens route together (:func:`activate_routing`); the MoE
layer offsets each rank's capacity positions by the ranks before it and
takes the capacity and the load-balancing statistics over the group.
"""
from __future__ import annotations

import dataclasses
import math
import os
import threading
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """logical axis name → tuple of candidate mesh axes (first that fits)."""
    rules: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
        ("batch",        (("pod", "data"), ("data",), None)),
        ("seq",          (None,)),
        ("seq_shard",    (("data",), None)),           # SP for long context
        ("embed",        (None,)),
        ("heads",        (("model",), None)),
        ("kv_heads",     (("model",), None)),
        ("seq_model",    (("model",), None)),
        ("head_dim",     (None,)),
        ("ff",           (("model",), None)),
        ("vocab",        (("model",), None)),
        ("experts",      (("model",), None)),
        ("expert_ff",    (("model",), None)),
        ("fsdp",         (("data",), None)),
        ("conv",         (None,)),
        ("state",        (None,)),
    )

    def lookup(self, name: str) -> Tuple:
        for k, v in self.rules:
            if k == name:
                return v
        return (None,)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes without ranks (``jax.sharding.AbstractMesh``):
    enough for the rules."""
    shape_tuple: Tuple[int, ...]
    axis_names: Tuple[str, ...]


_STATE = threading.local()


def set_axis_rules(rules: Optional[AxisRules]):
    _STATE.rules = rules


def _get_rules() -> AxisRules:
    return getattr(_STATE, "rules", None) or AxisRules()


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape_tuple))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def logical_to_mesh(logical: Sequence[Optional[str]], shape: Sequence[int],
                    mesh, rules: Optional[AxisRules] = None) -> Spec:
    """Resolve logical axes to a spec, honouring divisibility and never
    assigning one mesh axis twice."""
    rules = rules or _get_rules()
    sizes = mesh_axis_sizes(mesh)
    used: set = set()
    out = []
    for dim, name in zip(shape, logical):
        assigned = None
        if name is not None:
            for cand in rules.lookup(name):
                if cand is None:
                    break
                cand_t = cand if isinstance(cand, tuple) else (cand,)
                if any(c not in sizes for c in cand_t):
                    continue
                if any(c in used for c in cand_t):
                    continue
                total = math.prod(sizes[c] for c in cand_t)
                if dim % total == 0:
                    assigned = cand_t if len(cand_t) > 1 else cand_t[0]
                    used.update(cand_t)
                    break
        out.append(assigned)
    return tuple(out)


def _is_strided(p) -> bool:
    """Whether a placement is a strided shard (``_StridedShard``, which
    some torch versions derive from ``Shard`` and others do not)."""
    return type(p).__name__ == "_StridedShard"


def _split_of(p) -> int:
    """A placement's split factor: that of a strided shard, else 1."""
    return int(p.split_factor) if _is_strided(p) else 1


def _shard_dim(p) -> Optional[int]:
    """The tensor dim a placement splits (a ``Shard`` or a strided
    shard), or None."""
    from torch.distributed.tensor import Shard
    return p.dim if _is_strided(p) or isinstance(p, Shard) else None


def to_placements(spec: Spec, mesh, split: int = 1) -> Tuple:
    """DTensor placements on ``mesh`` for ``spec``: ``Shard(d)`` on every
    mesh dim that splits tensor dim ``d`` (with ``split`` above 1, the
    'model' axis's shard is strided: the dim is ``split`` equal blocks and
    each rank holds its shard of every block, in block order),
    ``Replicate()`` on the others. DTensor splits in mesh-dim order, which
    is the spec's major-to-minor order only while a tuple entry lists its
    axes in mesh order: asserted."""
    from torch.distributed.tensor import Replicate, Shard
    if split > 1:
        from torch.distributed.tensor.placement_types import _StridedShard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry} lists mesh axes out of "
                             f"mesh order {tuple(names)}")
        for p in pos:
            out[p] = Shard(d) if split == 1 or names[p] != "model" else \
                _StridedShard(d, split_factor=split)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A spec on a mesh (the reference's ``NamedSharding``); ``split``
    above 1 makes its 'model' shard strided (:func:`to_placements`)."""
    mesh: Any
    spec: Spec
    split: int = 1

    @property
    def placements(self) -> Tuple:
        return to_placements(self.spec, self.mesh, self.split)


def shard_index(shape, placements, mesh_sizes, coord) -> Tuple:
    """The index of the part of a tensor of ``shape`` that the rank at mesh
    coordinate ``coord`` holds under DTensor ``placements`` (even shards:
    the rules shard a dim only where the mesh axes divide it): a slice a
    dim, or for a strided shard of split ``s`` the positions of its shard
    of each of the dim's ``s`` blocks (a CPU ``LongTensor``). Mesh dims
    sharding one tensor dim split it in mesh-dim order, major to minor."""
    idx = []
    for d in range(len(shape)):
        k, n, split = 0, 1, 1
        for md, p in enumerate(placements):
            if _shard_dim(p) == d:
                k, n = k * mesh_sizes[md] + coord[md], n * mesh_sizes[md]
                split = max(split, _split_of(p))
        block = shape[d] // split
        step = block // n
        if split == 1:
            idx.append(slice(k * step, (k + 1) * step))
        else:
            idx.append(torch.cat([torch.arange(j * block + k * step,
                                               j * block + (k + 1) * step)
                                  for j in range(split)]))
    return tuple(idx)


def unstride(t: torch.Tensor, dim: int, n: int, split: int
             ) -> torch.Tensor:
    """The whole tensor from ``n`` ranks' strided shards of split
    ``split`` concatenated along ``dim`` in rank order (each shard its
    part of every block, in block order)."""
    if split == 1:
        return t
    dim = dim % t.ndim
    shape = tuple(t.shape)
    v = t.reshape(shape[:dim] + (n, split, shape[dim] // (n * split))
                  + shape[dim + 1:])
    return v.transpose(dim, dim + 1).reshape(shape)


def place(t: torch.Tensor, sharding: MeshSharding, device=None):
    """A DTensor of ``t`` (the whole tensor, present on every rank) on
    ``sharding``: each rank keeps its own shard, sliced locally — nothing is
    sent (``distribute_tensor(..., src_data_rank=None)``'s contract, by
    ``DTensor.from_local``) — and moves it to ``device`` (default: where
    ``t`` lies). A rank outside the mesh keeps an empty shard."""
    from torch.distributed.tensor import DTensor
    mesh = sharding.mesh
    placements = sharding.placements
    coord = mesh.get_coordinate()
    if coord is not None:
        local = t[shard_index(t.shape, placements, tuple(mesh.shape), coord)]
    else:
        local = t.new_empty((0,) * t.ndim)
    stride = torch.empty(t.shape, device="meta").stride()
    local = local.contiguous() if device is None else \
        local.to(device, memory_format=torch.contiguous_format)
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=t.shape, stride=stride)


# ---------------------------------------------------------------------------
# Parameter sharding rules (path/shape based)
# ---------------------------------------------------------------------------
# Conventions (repro_torch.models):
#   dense kernels    {"<proj>": {"w": (in, out)}}         — leaf name "w"
#   expert banks     {"moe": {"wi": {"w": (E, in, out)}}} — "moe" in path
#   embeddings       {"embedding": (V, d)}; lm head {"lm_head": {"w": (d, V)}}
#   stacked trees prepend one period dim ("periods" in path)
#
# Megatron-style placement: column-parallel projections put TP on the out
# dim, row-parallel on the in dim; everything else gets FSDP on its largest
# eligible dim. Divisibility fallbacks in logical_to_mesh handle the rest
# (e.g. mixtral's 8 experts on model=16 fall back to expert-ff TP).

_ROW_PARALLEL = {"wo", "wdown", "out_proj", "w_lora_b", "wv_cm"}
_TP = "heads_flat"   # resolves to 'model'

_PARAM_RULES = AxisRules(rules=AxisRules().rules + (
    ("heads_flat", (("model",), None)),
))


def param_sharding_rules(path: Tuple[str, ...], leaf: Any) -> Tuple:
    """Logical axes for a parameter leaf."""
    shape = getattr(leaf, "shape", ())
    rank = len(shape)
    name = path[-1] if path else ""
    parent = path[-2] if len(path) >= 2 else ""

    def pad(spec: Tuple) -> Tuple:
        """Prepend Nones for the stack dim(s) so spec matches rank."""
        if len(spec) < rank:
            return (None,) * (rank - len(spec)) + spec
        return spec

    if name == "embedding":
        return pad(("vocab", "fsdp"))
    if name == "conv_w":
        return pad((None, "ff"))
    if name in ("w", "w_q", "w_q4", "w_scale"):
        if parent == "w" or parent == "":
            return (None,) * rank
        if parent in ("w_lora_a", "w_lora_b") and \
                not os.environ.get("REPRO_LORA_TP"):
            # rwkv decay LoRA: ~0.26 M params/layer — replicated, so the
            # tiny matmul is duplicated instead of resharded per layer.
            # REPRO_LORA_TP=1 restores the naive TP sharding.
            return pad(("fsdp", None))
        if "lm_head" in path:
            spec = ("fsdp", "vocab")
        elif "moe" in path:                    # expert bank (E, in, out)
            spec = ("experts", "fsdp", "expert_ff")
        else:
            key = parent
            if key == "wv" and "cm" in path:
                key = "wv_cm"                  # rwkv channel-mix down-proj
            spec = (_TP, "fsdp") if key in _ROW_PARALLEL else ("fsdp", _TP)
        if name in ("w_q", "w_q4"):            # quantized codes: (out, in)
            spec = spec[:-2] + (spec[-1], spec[-2])
        elif name == "w_scale":                # (out, 1)
            spec = spec[:-2] + (spec[-1], None)
        return pad(spec)
    # vectors / norm gains / lerp factors / u bonus: replicate
    return (None,) * rank


def _paths(tree: Any, path: Tuple[str, ...] = ()):
    """``(path, leaf)`` of every leaf (dict keys, list indices as str);
    ``None`` leaves skipped."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _map_with_path(fn, tree: Any, path: Tuple[str, ...] = ()) -> Any:
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None or not hasattr(tree, "shape"):
        return tree
    return fn(path, tree)


def make_param_shardings(mesh, params_shape: Any,
                         rules: Optional[AxisRules] = None) -> Any:
    """``MeshSharding`` tree for a params tree (of tensors or anything with
    a ``shape``; other leaves, such as a clock integer, stay as they are)."""
    rules = rules or _PARAM_RULES

    def one(path, leaf):
        logical = param_sharding_rules(path, leaf)
        return MeshSharding(mesh, logical_to_mesh(logical, leaf.shape, mesh,
                                                  rules))

    return _map_with_path(one, params_shape)


def quantized_tensor_shardings(mesh, path: Tuple[str, ...], qt
                               ) -> Tuple[MeshSharding, MeshSharding]:
    """(codes, scale) ``MeshSharding`` for a pipeline ``QuantizedTensor``.

    ``path`` is the source kernel's tree path (…, parent, "w"); the codes and
    scales inherit the *serving-format* rules the same kernel would get as
    plain ``w_q``/``w_q4``/``w_scale`` arrays (transposed Megatron placement,
    divisibility fallbacks included). The pipeline's 2-D carriers collapse
    any stacked dims (experts, scan periods, conv taps) into the row dim, so
    rules written for the full stacked rank keep their trailing (row, col)
    entries — non-divisible collapsed dims fall back to replication inside
    ``logical_to_mesh``.
    """
    qname = "w_q4" if qt.packed else "w_q"
    logical_q = param_sharding_rules(path[:-1] + (qname,), qt.data)
    logical_s = param_sharding_rules(path[:-1] + ("w_scale",), qt.scale)
    logical_q = tuple(logical_q)[-qt.data.ndim:]
    logical_s = tuple(logical_s)[-qt.scale.ndim:]
    spec_q = logical_to_mesh(logical_q, qt.data.shape, mesh, _PARAM_RULES)
    spec_s = logical_to_mesh(logical_s, qt.scale.shape, mesh, _PARAM_RULES)
    return MeshSharding(mesh, spec_q), MeshSharding(mesh, spec_s)


def reshard_serving_tree(tree: Any, mesh) -> Any:
    """Place every leaf of a serving weight tree (fp params or the quantized
    ``w_q``/``w_q4``/``w_scale`` format) onto ``mesh``'s parameter
    shardings — the reshard-on-restore path: a tree checkpointed from a
    4-rank mesh lands bit-exactly on a 1- or 2-rank mesh because the
    checkpoint holds full logical arrays and :func:`place` only re-splits
    them. Nothing is sent between ranks."""
    shardings = make_param_shardings(mesh, tree)
    return _zip_map(lambda t, sh: place(t, sh) if isinstance(sh, MeshSharding)
                    else t, tree, shardings)


def gather_tree(tree: Any) -> Any:
    """Every DTensor leaf of ``tree`` (and of its ``QuantizedTensor``s)
    gathered to its whole tensor on this rank (``group.full_tensor``, a
    collective: every rank of the mesh calls it); other leaves as they
    are."""
    from repro_torch.distributed.group import full_tensor
    from repro_torch.quant.qtypes import QuantizedTensor

    def one(_, t):
        if isinstance(t, QuantizedTensor):
            return dataclasses.replace(t, data=full_tensor(t.data),
                                       scale=full_tensor(t.scale))
        return full_tensor(t)
    return _map_with_path(one, tree)


def _zip_map(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _zip_map(fn, a[k], b[k]) for k in a}
    if isinstance(a, (list, tuple)):
        return type(a)(_zip_map(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


# ---------------------------------------------------------------------------
# Cache sharding rules (serving)
# ---------------------------------------------------------------------------

_CACHE_LOGICAL: Dict[str, Tuple] = {
    "k":       ("batch", "seq_cache", "kv_heads", "head_dim"),
    "v":       ("batch", "seq_cache", "kv_heads", "head_dim"),
    "k_scale": ("batch", "seq_cache", "kv_heads"),
    "v_scale": ("batch", "seq_cache", "kv_heads"),
    "c_kv":    ("batch", "seq_cache", "mla_rank"),
    "k_rope":  ("batch", "seq_cache", None, None),
    "h":       ("batch", "d_inner", None),
    "conv":    ("batch", None, "d_inner"),
    "wkv":     ("batch", "heads", None, None),
    "x_tm":    ("batch", None),
    "x_cm":    ("batch", None),
    "enc_out": ("batch", None, None),
}

# Paged pools put K/V in (num_blocks, block_size, kv_heads, head_dim):
# the pool dim takes the DP axes (each rank holds a slice of the block
# pool — the paged analogue of sequence parallelism), while the tiny
# block_size dim is never split.
_PAGED_CACHE_LOGICAL: Dict[str, Tuple] = {
    "k":       ("kv_blocks", None, "kv_heads", "head_dim"),
    "v":       ("kv_blocks", None, "kv_heads", "head_dim"),
    "k_scale": ("kv_blocks", None, "kv_heads"),
    "v_scale": ("kv_blocks", None, "kv_heads"),
}

_CACHE_RULES = AxisRules(rules=(
    # long-context SP: the cache sequence dim takes whatever DP axes the
    # (possibly tiny) batch left unused — 500k decode shards its KV over them
    ("seq_cache", (("pod", "data"), ("data",), None)),
    ("kv_blocks", (("pod", "data"), ("data",), None)),
    ("mla_rank",  (("model",), None)),
    ("d_inner",   (("model",), None)),
    ("head_dim",  (("model",), None)),
) + AxisRules().rules)


def make_cache_shardings(mesh, cache_shape: Any, paged: bool = False) -> Any:
    """``MeshSharding`` tree for a cache tree (tensors or anything with a
    ``shape``; a host-integer clock stays as it is)."""
    table = _PAGED_CACHE_LOGICAL if paged else _CACHE_LOGICAL

    def one(path, leaf):
        name = path[-1] if path else ""
        logical = table.get(name)
        if logical is None and paged:
            logical = _CACHE_LOGICAL.get(name)
        if logical is None:
            logical = (None,) * len(leaf.shape)
        if len(logical) != len(leaf.shape):
            stack = len(leaf.shape) - len(logical)
            logical = (None,) * stack + tuple(logical)
        return MeshSharding(mesh, logical_to_mesh(logical, leaf.shape, mesh,
                                                  _CACHE_RULES))

    return _map_with_path(one, cache_shape)


# ---------------------------------------------------------------------------
# Tensor-parallel execution over 'model'
# ---------------------------------------------------------------------------

class _Active:
    """What :func:`activate_mesh` and :func:`activate_routing` return:
    leaving it as a context manager puts the previous ``name`` (the mesh,
    the routing group) back."""

    def __init__(self, name, prev):
        self.name, self.prev = name, prev

    def __enter__(self):
        return getattr(_STATE, self.name, None)

    def __exit__(self, *exc):
        setattr(_STATE, self.name, self.prev)


def activate_mesh(mesh):
    """Install ``mesh`` (a ``DeviceMesh``, or None) as this thread's active
    mesh, as the reference's ``compat.activate_mesh`` does; used as a
    context manager, the previous one comes back on exit. The forward's
    collectives run over its 'model' axis."""
    prev = current_mesh()
    _STATE.mesh = mesh
    return _Active("mesh", prev)


def current_mesh():
    """This thread's active mesh, or None."""
    return getattr(_STATE, "mesh", None)


def model_axis() -> Tuple[int, int, Any]:
    """``(size, coordinate, group)`` of the active mesh's 'model' axis;
    ``(1, 0, None)`` with no active mesh or a 'model' axis of 1."""
    mesh = current_mesh()
    if mesh is None or mesh_axis_sizes(mesh).get("model", 1) == 1:
        return 1, 0, None
    return (mesh_axis_sizes(mesh)["model"], mesh.get_local_rank("model"),
            mesh.get_group("model"))


def shard_act(x: torch.Tensor) -> torch.Tensor:
    """The reference's constraint of an activation to its replicated-over-
    'model' layout, at a point where the port's ``x`` holds this rank's
    partial sums (a row-parallel product, a vocab-parallel lookup): under a
    'model' axis above 1 the all-reduce GSPMD inserts there
    (reduce-from-model: identity backward); otherwise ``x`` as it is."""
    tp, _, g = model_axis()
    if tp == 1:
        return x
    from repro_torch.distributed.group import reduce_from_model
    return reduce_from_model(x, g)


def to_model(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over 'model', entering model-sharded products (the
    normed input of q/k/v or wi/wg, a vocab-parallel head's input, a
    qk-norm gain applied to the local heads): copy-to-model, identity
    forward and the gradient all-reduced over 'model' backward. Identity
    without a 'model' axis above 1."""
    tp, _, g = model_axis()
    if tp == 1:
        return x
    from repro_torch.distributed.group import copy_to_model
    return copy_to_model(x, g)


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, this rank's partial sum of a quantity every 'model' rank
    uses whole (mamba's ``x_proj`` product over its ``d_inner`` channels,
    rwkv's ``ln_x`` sum of squares over its heads' channels), summed over
    'model' forward and backward (:func:`to_model`, then
    :func:`shard_act`): each rank uses the sum on its own channels, so
    each rank's gradient of it is partial. Identity without a 'model'
    axis above 1."""
    return shard_act(to_model(x))


def local_slice(t: torch.Tensor, width: int, dim: int = 0) -> torch.Tensor:
    """A replicated leaf that this rank uses in part (mamba's ``conv_b``,
    ``dt_bias``, ``a_log`` and ``d_skip`` on its ``d_inner`` channels,
    rwkv's ``u`` and ``ln_x`` gain on its heads): through :func:`to_model`
    (its gradient summed over 'model', so whole on every rank), then this
    rank's ``width`` entries along ``dim``, ``[k·width, (k+1)·width)`` at
    'model' coordinate ``k``. ``t`` as it is where it holds ``width``."""
    tp, k, _ = model_axis()
    if tp == 1 or t.shape[dim] == width:
        return t
    return to_model(t).narrow(dim, k * width, width)


def replica_groups(n: int, tp: int) -> Tuple[int, int]:
    """``(g, r)`` of a count ``n`` (q heads, KV heads, FFN columns) on a
    'model' axis of ``tp``: ``g = gcd(n, tp)`` contiguous shards of ``n /
    g`` units, each held by ``r = tp / g`` consecutive ranks; the rank at
    'model' coordinate ``k`` holds shard ``k // r``. ``r`` is 1 where
    ``tp`` divides ``n``."""
    g = math.gcd(n, tp)
    return g, tp // g


def group_slice(t: torch.Tensor, n: int, width: int, dim: int
                ) -> torch.Tensor:
    """A leaf cut by ``n`` units (``width`` entries along ``dim`` when
    whole) as this rank's replica-group shard (:func:`replica_groups`): a
    whole fp leaf (:func:`tp_place`'s ``Replicate``) through
    :func:`to_model` (each rank's gradient of it is partial: summed over
    'model'), then shard ``k // r`` of ``g`` along ``dim``, as
    :func:`local_slice` narrows at ``k``. ``t`` as it is where 'model'
    divides ``n`` (the plain cut), where it already holds the shard
    (:func:`tp_local`'s tree) and for a quantized leaf (always
    :func:`tp_local`'s cut)."""
    tp, k, _ = model_axis()
    g, r = replica_groups(n, tp)
    if r == 1 or not isinstance(t, torch.Tensor) or t.shape[dim] != width:
        return t
    local = width // g
    return to_model(t).narrow(dim, (k // r) * local, local)


def first_replica(n: int) -> bool:
    """Whether this rank is the first of its replica group for ``n`` units
    (:func:`replica_groups`): the one rank of the group whose row-parallel
    partial product enters the sum over 'model' (the others add exact
    zeros). True without a 'model' axis above 1 and where it divides
    ``n``."""
    tp, k, _ = model_axis()
    return k % replica_groups(n, tp)[1] == 0


def gather_cols(x: torch.Tensor, width: int) -> torch.Tensor:
    """A column-parallel product's output, whole on every rank: this
    rank's ``(..., width / tp)`` columns all-gathered over 'model'
    (gather-from-model: this rank's slice of the gradient backward); an
    output that already holds ``width`` columns (a product the rules left
    replicated) comes back as it is."""
    tp, _, g = model_axis()
    if tp == 1 or x.shape[-1] == width:
        return x
    from repro_torch.distributed.group import gather_from_model
    return gather_from_model(x, g)


def shard_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """LM-head logits, whole on every rank (:func:`gather_cols`): a
    vocab-parallel head's local ``(..., vocab / tp)`` logits are gathered
    over 'model', so the loss is the reference's arithmetic on the whole
    row; a replicated head's (the vocab 'model' does not divide) come back
    as they are."""
    return gather_cols(logits, vocab)


def vocab_parallel(vocab: int) -> bool:
    """True where the active 'model' axis shards the vocabulary (the rules
    put 'vocab' on 'model' where it divides)."""
    tp = model_axis()[0]
    return tp > 1 and vocab % tp == 0


@dataclasses.dataclass(frozen=True)
class RoutingGroup:
    """The data-parallel ranks whose tokens the reference routes together,
    as process groups major to minor (each ``None`` for the default group):
    the 'pod' and 'data' groups of the plain step (the global batch), the
    'data' group of the pod-compressed one (the pod's batch). Every rank
    holds an equal, contiguous slice of the routed tokens, in ``index``
    order."""
    groups: Tuple[Any, ...]
    sizes: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def activate_routing(group: Optional[RoutingGroup]):
    """Install ``group`` as this thread's MoE routing group (None: each
    rank routes its own tokens); used as a context manager, the previous
    one comes back on exit."""
    prev = getattr(_STATE, "routing", None)
    _STATE.routing = group
    return _Active("routing", prev)


def current_routing() -> Optional[RoutingGroup]:
    """This thread's routing group of more than one rank, or None."""
    g = getattr(_STATE, "routing", None)
    return g if g is not None and g.size > 1 else None


@dataclasses.dataclass(frozen=True)
class FsdpPlan:
    """What an FSDP train step's forward gathers: the 'data' process group
    (``None``: the default group), and ``{id(local shard): the dim its
    'data' shard cuts}`` of the tensors the step hands the forward."""
    group: Any
    dims: Dict[int, int]


def activate_fsdp(plan: Optional[FsdpPlan]):
    """Install ``plan`` as this thread's FSDP plan (None: nothing is
    gathered); used as a context manager, the previous one comes back on
    exit."""
    prev = current_fsdp()
    _STATE.fsdp = plan
    return _Active("fsdp", prev)


def current_fsdp() -> Optional[FsdpPlan]:
    """This thread's FSDP plan, or None."""
    return getattr(_STATE, "fsdp", None)


def gather_params(tree: Any) -> Any:
    """``tree`` (a period's parameters, the embedding, the head) with every
    shard of the active :class:`FsdpPlan` gathered over 'data' along its
    dim, in one collective (``group.gather_data``: the gradients come back
    reduce-scattered to the shards); ``tree`` as it is without a plan or
    with no shard of the plan in it."""
    plan = current_fsdp()
    if plan is None:
        return tree
    mine = [t for _, t in _paths(tree)
            if isinstance(t, torch.Tensor) and id(t) in plan.dims]
    if not mine:
        return tree
    from repro_torch.distributed.group import gather_data
    whole = gather_data(mine, [plan.dims[id(t)] for t in mine], plan.group)
    by_id = {id(t): w for t, w in zip(mine, whole)}
    return _map_with_path(lambda _, t: by_id.get(id(t), t), tree)


def expert_ff(n_experts: int, tp: int) -> bool:
    """Whether an MoE of ``n_experts`` takes the reference's 'expert_ff'
    fallback on a 'model' axis of ``tp``: 'model' does not divide the
    experts, so it cuts every expert's FFN columns instead."""
    return n_experts % tp != 0


def local_experts(n_experts: int) -> Tuple[int, int]:
    """``(first, count)`` of the experts this rank holds under the active
    'model' axis: the rank at 'model' coordinate ``k`` of ``tp`` holds
    experts ``[k·E/tp, (k+1)·E/tp)`` where 'model' divides ``E``, and all
    of them, each cut to its FFN columns, where it does not
    (:func:`expert_ff`; ``(0, E)`` without a 'model' axis)."""
    tp, k, _ = model_axis()
    if expert_ff(n_experts, tp):
        return 0, n_experts
    per = n_experts // tp
    return k * per, per


def tp_not_ported(what: str) -> str:
    """The message of a case tensor-parallel execution does not take."""
    return f"not ported yet: {what} under tensor-parallel execution (M7c)"


def check_tensor_parallel(cfg, mesh) -> None:
    """Raise ``NotImplementedError("not ported yet: …")`` where the port
    cannot run ``cfg`` tensor-parallel on ``mesh`` (a ``DeviceMesh`` or an
    :class:`AbstractMesh`; its 'data' axis, FSDP included, takes any
    config): an MoE whose expert count and expert FFN
    width the 'model' axis divides neither of (the reference leaves the
    bank whole there, and each rank's whole product would be summed once
    per rank), MLA latent ranks (``q_lora``, ``kv_lora + rope_dim``) it
    does not divide (the rules leave ``q_down`` / ``kv_down`` whole there,
    and a whole product's gradient would be summed over 'model' once per
    rank), a mamba ``d_inner`` it does not divide (the same, for
    ``in_proj``, ``conv_w``, ``x_proj``, ``dt_proj`` and ``out_proj``), or
    rwkv heads or an rwkv channel-mix width it does not divide. q and KV
    heads (GQA, MLA, the encoder's and the cross-attention's) and a dense
    FFN width that 'model' does not divide run on replica groups
    (:func:`replica_groups`): the reference's rule cuts inside a head
    there, the port keeps heads whole. An expert count it does not divide
    takes the 'expert_ff' fallback (:func:`expert_ff`)."""
    tp = mesh_axis_sizes(mesh).get("model", 1)
    if tp == 1:
        return
    plan = cfg.block_pattern or ()
    moe, m = cfg.moe, cfg.mla
    d_inner = cfg.mamba.expand * cfg.d_model if "m" in plan else 0
    rwkv_heads = cfg.d_model // cfg.rwkv_head_dim if cfg.rwkv else 0
    cases = (
        (moe is not None and expert_ff(moe.n_experts, tp)
         and cfg.d_ff % tp != 0,
         f"{moe and moe.n_experts} experts and their FFN width {cfg.d_ff} "
         f"on a 'model' axis of {tp}"),
        (m is not None and (m.q_lora % tp or (m.kv_lora + m.rope_dim) % tp),
         f"MLA latent ranks on a 'model' axis of {tp} (q_lora "
         f"{m and m.q_lora}, kv_lora + rope_dim "
         f"{m and m.kv_lora + m.rope_dim})"),
        (d_inner % tp != 0, f"mamba's d_inner {d_inner} on a 'model' axis "
                            f"of {tp}"),
        (rwkv_heads % tp != 0, f"rwkv's {rwkv_heads} heads on a 'model' "
                               f"axis of {tp}"),
        (cfg.rwkv and cfg.d_ff % tp != 0, f"rwkv's channel-mix d_ff "
                                          f"{cfg.d_ff} on a 'model' axis "
                                          f"of {tp}"),
    )
    for hit, what in cases:
        if hit:
            raise NotImplementedError(tp_not_ported(what))


def _tp_spec(spec: Spec) -> Spec:
    """The 'model' entries of a spec (every other axis replicated)."""
    def one(e):
        axes = e if isinstance(e, tuple) else (e,)
        return "model" if "model" in axes else None
    return tuple(one(e) for e in spec)


# where the port's tensor-parallel layout leaves the reference's rules
# (models.mamba): x_proj is row-parallel over d_inner (the rules cut its
# outputs), and in_proj's two halves, x and z, are each cut on 'model'
# (the rules cut its output contiguously: rank 0 would hold x, rank 1 z)
_TP_ROW_PARALLEL = {"x_proj"}
_TP_PAIRED = {"in_proj"}


def group_units(path: Tuple[str, ...], cfg) -> Optional[Tuple[int, bool]]:
    """``(n, row_parallel)`` of a dense leaf that 'model' cuts by whole
    units (:func:`replica_groups`): a GQA block's ``wq`` / ``wo`` (the q
    heads) and ``wk`` / ``wv`` (the KV heads), an MLA block's ``q_up``,
    ``kv_up`` and ``wo`` (its heads), a cross-attention's or an encoder
    layer's four (its heads, K/V at ``n_heads``), a dense FFN's ``wi`` /
    ``wg`` / ``wdown`` (``d_ff`` columns, the encoder's too); None for
    every other leaf. ``path`` ends in the leaf's name (``w``, ``w_q``,
    ``w_q4``, ``w_scale``)."""
    if len(path) < 3:
        return None
    node, block = path[-2], path[-3]
    if block == "xattn" or block == "attn" and path[0] == "encoder":
        # cross-attention and the encoder's: K/V at n_heads
        if node in ("wq", "wk", "wv", "wo"):
            return cfg.n_heads, node == "wo"
    elif block == "attn" and cfg.mla is not None:
        if node in ("q_up", "kv_up", "wo"):
            return cfg.n_heads, node == "wo"
    elif block == "attn":
        if node in ("wq", "wo"):
            return cfg.n_heads, node == "wo"
        if node in ("wk", "wv"):
            return cfg.n_kv_heads, False
    elif block == "ffn" and node in ("wi", "wg", "wdown"):
        return cfg.d_ff, node == "wdown"
    return None


def _grouped(path, mesh, cfg) -> Optional[Tuple[int, int, bool, int]]:
    """``(g, r, row_parallel, experts)`` of a leaf cut by whole units
    (:func:`group_units`) under ``mesh``'s 'model' axis (``r`` 1 for the
    plain cut, ``experts`` 1), or of an expert bank's ``wi`` / ``wg`` /
    ``wdown`` under the 'expert_ff' fallback (:func:`expert_ff`: ``(tp,
    1, wdown, E)``, every expert's FFN columns cut alike), else None."""
    tp = mesh_axis_sizes(mesh).get("model", 1)
    units = group_units(path, cfg)
    if units is not None:
        return replica_groups(units[0], tp) + (units[1], 1)
    if "moe" in path and len(path) >= 2 and \
            path[-2] in ("wi", "wg", "wdown") and tp > 1 and \
            expert_ff(cfg.moe.n_experts, tp):
        return tp, 1, path[-2] == "wdown", cfg.moe.n_experts
    return None


def _cut_spec(ndim: int, dim: int) -> Spec:
    """A spec that puts 'model' on ``dim`` of an ``ndim``-dim leaf."""
    return tuple("model" if i == dim % ndim else None for i in range(ndim))


def _expert_ff_sharding(mesh, path, leaf, grouped):
    """:func:`make_tp_shardings`' entry of an expert bank's leaf under the
    'expert_ff' fallback (``grouped`` of :func:`_grouped`): the fp ``(E,
    in, out)`` kernel on its ``d_ff`` dim; the serving form's ``(E, out,
    in)`` codes on theirs, a per-channel ``w_scale`` of ``wdown`` whole; a
    ``QuantizedTensor``'s ``(E·d_ff, d)`` codes and scale rows of ``wi`` /
    ``wg`` a strided shard of split E, ``wdown``'s ``(E·d, d_ff)`` codes on
    their columns (:func:`tp_local` cuts a per-group scale's columns)."""
    from repro_torch.quant.qtypes import QuantizedTensor
    row, experts = grouped[2], grouped[3]
    if isinstance(leaf, QuantizedTensor):
        if row:
            return (MeshSharding(mesh, (None, "model")),
                    MeshSharding(mesh, (None,) * leaf.scale.ndim))
        return (MeshSharding(mesh, ("model", None), experts),
                MeshSharding(mesh, _cut_spec(leaf.scale.ndim, 0), experts))
    name = path[-1]
    if name == "w":
        return MeshSharding(mesh, _cut_spec(leaf.ndim, -2 if row else -1))
    if not row:
        return MeshSharding(mesh, _cut_spec(leaf.ndim, -2))
    if name == "w_scale" and leaf.shape[-1] == 1:
        return MeshSharding(mesh, (None,) * leaf.ndim)
    return MeshSharding(mesh, _cut_spec(leaf.ndim, -1))


def make_tp_shardings(mesh, tree: Any, cfg) -> Any:
    """``MeshSharding`` tree of the params tree of config ``cfg`` in its
    tensor-parallel layout: the 'model' entries of
    :func:`make_param_shardings` (the 'data' FSDP entries replicated). A
    ``QuantizedTensor`` leaf gets a ``(codes, scale)`` pair
    (:func:`quantized_tensor_shardings`). An MoE router stays whole
    (every rank routes every token; the rules would put its input dim on
    'model'); an expert bank is cut on its expert dim, which the
    pipeline's ``(E·out, in)`` codes and their scale rows carry major, so
    a 'model' axis dividing E cuts them at expert boundaries; one that
    does not divide E cuts every expert's FFN columns (the 'expert_ff'
    fallback, :func:`_expert_ff_sharding`). mamba's
    ``x_proj`` takes the row-parallel rule, and ``in_proj``'s output dim
    (its codes' and scales' rows) a strided shard of split 2: each rank
    the same columns of x and of z. A leaf cut by heads or FFN columns
    that 'model' does not divide (:func:`group_units`) is whole on every
    rank (``Replicate``): the forward narrows it to the rank's
    replica-group shard (:func:`group_slice`), where the reference's rule
    would cut inside a head."""
    from repro_torch.quant.qtypes import QuantizedTensor

    def one(path, leaf):
        grouped = _grouped(path, mesh, cfg)
        if grouped is not None and grouped[3] > 1:
            return _expert_ff_sharding(mesh, path, leaf, grouped)
        if "router" in path or (grouped is not None and grouped[1] > 1):
            whole = MeshSharding(mesh, (None,) * len(leaf.shape))
            if isinstance(leaf, QuantizedTensor):
                return whole, MeshSharding(mesh, (None,) * leaf.scale.ndim)
            return whole
        node = path[-2] if len(path) >= 2 else ""
        if node in _TP_ROW_PARALLEL:
            path = path[:-2] + ("out_proj", path[-1])
        split = 2 if node in _TP_PAIRED else 1
        if isinstance(leaf, QuantizedTensor):
            return tuple(MeshSharding(mesh, _tp_spec(s.spec), split) for s in
                         quantized_tensor_shardings(mesh, path, leaf))
        spec = logical_to_mesh(param_sharding_rules(path, leaf), leaf.shape,
                               mesh, _PARAM_RULES)
        return MeshSharding(mesh, _tp_spec(spec), split)
    return _map_with_path(one, tree)


def _local(t: torch.Tensor, sharding: MeshSharding) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` (contiguous)."""
    mesh = sharding.mesh
    return t[shard_index(t.shape, sharding.placements, tuple(mesh.shape),
                         mesh.get_coordinate())].contiguous()


def _split_error(path, tp: int, what: str, cols: int) -> ValueError:
    return ValueError(f"{'/'.join(path)}: a 'model' axis of {tp} splits a "
                      f"{what} of its {cols} input columns")


def _local_quantized(qt, shardings, path):
    """This rank's ``QuantizedTensor`` of a whole one that is not cut by
    heads or FFN columns (:func:`_group_local` cuts those: an expert bank,
    mamba's and rwkv's leaves, the head): codes and scale rows of a
    column-parallel leaf, the codes' columns of a row-parallel one
    with the per-group scale's columns of the same groups (a per-channel
    scale stays whole: it scales each partial product exactly). A shard
    never splits a group or a packed int4 byte."""
    from repro_torch.quant.qtypes import QuantizedTensor
    sh_q, sh_s = shardings
    codes = _local(qt.data, sh_q)
    scale = _local(qt.scale, sh_s)
    out, cols = qt.shape[0], math.prod(qt.shape[1:])
    if sh_q.spec[-1] == "model":                 # row-parallel: in sharded
        tp = mesh_axis_sizes(sh_q.mesh)["model"]
        cols //= tp
        unit = qt.group_size or (2 if qt.packed else 1)
        if cols % unit:
            what = f"group of {qt.group_size}" if qt.group_size \
                else "packed byte"
            raise _split_error(path, tp, what, math.prod(qt.shape[1:]))
        if qt.scale.shape[-1] > 1:           # per-group: this rank's groups
            g = qt.scale.shape[-1] // tp
            k = sh_q.mesh.get_local_rank("model")
            scale = scale[:, k * g:(k + 1) * g].contiguous()
    elif sh_q.spec[0] == "model":                # column-parallel: out sharded
        out //= mesh_axis_sizes(sh_q.mesh)["model"]
    return QuantizedTensor(data=codes, scale=scale, bits=qt.bits,
                           group_size=qt.group_size, shape=(out, cols))


def _group_cut(t: torch.Tensor, dim: int, g: int, s: int,
               blocks: int = 1) -> torch.Tensor:
    """Shard ``s`` of ``g`` equal contiguous parts of ``t`` along ``dim``;
    with ``blocks`` above 1, shard ``s`` of each of the dim's ``blocks``
    equal blocks, in block order (a strided shard)."""
    if blocks > 1:
        dim %= t.ndim
        shape = tuple(t.shape)
        v = t.reshape(shape[:dim] + (blocks, shape[dim] // blocks)
                      + shape[dim + 1:])
        return _group_cut(v, dim + 1, g, s).reshape(
            shape[:dim] + (-1,) + shape[dim + 1:])
    w = t.shape[dim] // g
    return t.narrow(dim, s * w, w).contiguous()


def _group_local(leaf, path, mesh, grouped):
    """This rank's replica-group shard of a whole leaf cut by heads or FFN
    columns (:func:`_grouped`; the plain cut where ``r`` is 1):
    an fp ``(in, out)`` kernel by columns (column-parallel) or rows
    (row-parallel); a ``QuantizedTensor`` or the serving format's ``w_q`` /
    ``w_q4`` / ``w_scale`` (``(out, in)``-major) by codes' and scale rows,
    or by the codes' input columns with a per-group scale's columns of the
    same groups (a per-channel scale whole). A shard never splits a group
    or a packed int4 byte: ``ValueError``. An expert bank under the
    'expert_ff' fallback (``experts`` above 1) is cut alike in every
    expert: its fp ``(E, in, out)`` kernel and serving ``(E, out, in)``
    codes on their ``d_ff`` dim, a ``QuantizedTensor``'s ``(E·d_ff, d)``
    rows in each expert's block."""
    from repro_torch.quant.qtypes import QuantizedTensor
    g, r, row, experts = grouped
    tp = mesh_axis_sizes(mesh)["model"]
    s = mesh.get_local_rank("model") // r
    if isinstance(leaf, QuantizedTensor):
        out, cols = leaf.shape[0], math.prod(leaf.shape[1:])
        if not row:
            return QuantizedTensor(
                data=_group_cut(leaf.data, 0, g, s, experts),
                scale=_group_cut(leaf.scale, 0, g, s, experts),
                bits=leaf.bits, group_size=leaf.group_size,
                shape=(out // g, cols))
        unit = leaf.group_size or (2 if leaf.packed else 1)
        if cols % (g * unit):
            what = f"group of {leaf.group_size}" if leaf.group_size \
                else "packed byte"
            raise _split_error(path, tp, what, cols)
        scale = leaf.scale if leaf.scale.shape[-1] == 1 else \
            _group_cut(leaf.scale, -1, g, s)
        return QuantizedTensor(data=_group_cut(leaf.data, -1, g, s),
                               scale=scale, bits=leaf.bits,
                               group_size=leaf.group_size,
                               shape=(out, cols // g))
    name = path[-1]
    if name == "w":                                # fp (in, out)
        return _group_cut(leaf, -2 if row else -1, g, s)
    if not row:                                    # (out, in)-major rows
        return _group_cut(leaf, -2, g, s)
    if name == "w_scale" and leaf.shape[-1] == 1:  # per-channel: whole
        return leaf
    if leaf.shape[-1] % g:
        raise _split_error(path, tp, "group" if name == "w_scale"
                           else "packed byte", leaf.shape[-1])
    return _group_cut(leaf, -1, g, s)


def tp_local(tree: Any, mesh, cfg) -> Any:
    """This rank's tensor-parallel tree of a whole fp or quantized tree of
    config ``cfg`` (plain tensors, pipeline ``QuantizedTensor``s or the
    ``w_q``/``w_q4``/``w_scale`` serving format), every rank holding the
    whole tree: each leaf sliced to this rank's shard of
    :func:`make_tp_shardings`, nothing sent; a leaf cut by heads or FFN
    columns to this rank's replica-group shard (:func:`replica_groups`),
    an expert bank under the 'expert_ff' fallback to its FFN columns of
    every expert. What the forward runs on under :func:`activate_mesh`."""
    from repro_torch.quant.qtypes import QuantizedTensor
    shardings = make_tp_shardings(mesh, tree, cfg)

    def one(path, leaf):
        grouped = _grouped(path, mesh, cfg)
        if grouped is not None:
            return _group_local(leaf, path, mesh, grouped)
        sh = _get_path(shardings, path)
        if isinstance(leaf, QuantizedTensor):
            return _local_quantized(leaf, sh, path)
        return _local(leaf, sh)
    return _map_with_path(one, tree)


def tp_place(tree: Any, mesh, cfg) -> Any:
    """A whole fp tree of config ``cfg`` as DTensors on its
    tensor-parallel layout (:func:`make_tp_shardings`): each rank keeps
    its shard, nothing is sent. What the tensor-parallel train step and
    the checkpointer take."""
    return _zip_map(lambda t, sh: place(t, sh) if isinstance(sh, MeshSharding)
                    else t, tree, make_tp_shardings(mesh, tree, cfg))


def _fsdp_dim(path, leaf, mesh) -> Optional[int]:
    """The dim of ``leaf`` that the reference's rules put 'data' on (the
    ``"fsdp"`` entry, where 'data' divides it), or None."""
    spec = logical_to_mesh(param_sharding_rules(path, leaf), leaf.shape,
                           mesh, _PARAM_RULES)
    for d, e in enumerate(spec):
        if "data" in (e if isinstance(e, tuple) else (e,)):
            return d
    return None


def make_fsdp_shardings(mesh, tree: Any, cfg) -> Any:
    """``MeshSharding`` tree of the fp params tree of config ``cfg`` in its
    FSDP (ZeRO-3) layout: :func:`make_tp_shardings`' 'model' layout, and
    'data' on the dim the reference's rule marks ``"fsdp"`` where 'data'
    divides it; where that dim is the one 'model' cuts (mamba's
    row-parallel ``x_proj``, the 'expert_ff' fallback's ``wdown``), on
    the leaf's other matrix dim if 'data' divides that one. Vectors and
    norm gains stay replicated; a ``QuantizedTensor`` keeps its
    tensor-parallel pair."""
    shardings = make_tp_shardings(mesh, tree, cfg)
    n = mesh_axis_sizes(mesh).get("data", 1)

    def one(path, leaf):
        sh = _get_path(shardings, path)
        if n == 1 or not isinstance(sh, MeshSharding):
            return sh
        dim = _fsdp_dim(path, leaf, mesh)
        if dim is None:
            return sh
        spec = list(sh.spec)
        if spec[dim] is not None:
            dim = leaf.ndim - 1 if dim == leaf.ndim - 2 else leaf.ndim - 2
            if spec[dim] is not None or leaf.shape[dim] % n:
                return sh
        spec[dim] = "data"
        return MeshSharding(mesh, tuple(spec), sh.split)
    return _map_with_path(one, tree)


def fsdp_place(tree: Any, mesh, cfg) -> Any:
    """A whole fp tree of config ``cfg`` as DTensors on its FSDP layout
    (:func:`make_fsdp_shardings`): each rank keeps its shard, nothing is
    sent. What the train step shards its parameters and AdamW moments
    over 'data' with (``adamw_init`` of the placed tree places the
    moments alike)."""
    return _zip_map(lambda t, sh: place(t, sh) if isinstance(sh, MeshSharding)
                    else t, tree, make_fsdp_shardings(mesh, tree, cfg))


def _get_path(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def placement_spec(t) -> Spec:
    """The spec of a DTensor's placements (mesh axes in mesh order)."""
    spec = [[] for _ in range(t.ndim)]
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if _shard_dim(p) is not None:
            spec[p.dim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in spec)


def placement_split(t) -> int:
    """The split factor of a DTensor's strided shard (1: none)."""
    return max((_split_of(p) for p in t.placements), default=1)


def model_shard(t) -> Optional[Tuple[int, int]]:
    """``(dim, split)`` of the shard a DTensor's 'model' axis cuts (None:
    the leaf is whole on every 'model' rank)."""
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == "model" and _shard_dim(p) is not None:
            return p.dim, _split_of(p)
    return None


def data_shard(t) -> Optional[int]:
    """The dim a DTensor's 'data' axis cuts (FSDP; None: the leaf is whole
    on every 'data' rank). A strided 'data' shard raises ``ValueError``
    (no layout of the port makes one)."""
    for name, p in zip(t.device_mesh.mesh_dim_names, t.placements):
        if name == "data" and _shard_dim(p) is not None:
            if _is_strided(p):
                raise ValueError("a strided shard over 'data'")
            return p.dim
    return None


def shardings_of(tree: Any) -> Any:
    """``MeshSharding`` of every DTensor leaf of ``tree`` (None for other
    leaves): what restores a checkpoint onto the same layout."""
    from torch.distributed.tensor import DTensor
    return _map_with_path(
        lambda _, t: MeshSharding(t.device_mesh, placement_spec(t),
                                  placement_split(t))
        if isinstance(t, DTensor) else None, tree)
