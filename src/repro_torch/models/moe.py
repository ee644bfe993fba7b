"""Mixture-of-Experts: GShard/Switch-style top-k routing with capacity.

Dispatch and combine are dense ``(tokens, experts, capacity)`` one-hot
tensors, as in the reference package, so every shape follows from the
input's and the whole function is one CUDA-graph capture (no host sync, no
data-dependent shape).

Expert kernels are stacked ``(experts, in, out)`` tensors named ``w``; the
quantization pipeline treats each expert's matrix independently
(per-expert, per-channel scales) and stores a bank as ``(experts*out, in)``
codes (``core.pipeline``) or ``(experts, out, in)`` codes (``quant.apply``'s
``w_q``/``w_q4``).

The routing is discontinuous (a one-ulp change of a router logit can change
an expert), so the arithmetic mirrors the reference's: the router product in
the activation dtype, softmax in float32, top-k with ties to the lower
index, gates renormalized with a ``1e-9`` floor, capacity rounded up,
positions by a cumulative sum over the token-major ``(T*K, E)`` flattening,
dispatch and combine built in the activation dtype.

Experts of a quantized bank: on a CUDA tensor each expert goes through the
dequant-matmul kernel on a zero-copy view of its rows (codes are read once;
no dequantized bank is made); the plain version, which the CPU runs, is the
reference's form: the bank dequantized to the activation dtype and one
batched ``torch.matmul``.

Under a data-parallel routing group (``sharding.activate_routing``) each
rank routes its contiguous slice of the tokens the reference routes
together: top-k and the gates are per token; the capacity comes from the
group's token count, each rank's capacity positions are offset by the
per-expert counts of the ranks before it (one ``(R, E)`` all-gather), and
the aux loss's density and mean probability are sums over the group (one
``(2, E)`` all-reduce, summed backward too). A rank's capacity buffer
holds only its own tokens' slots: its kept tokens per expert are at most
its token count.

Expert-parallel under an active 'model' axis above 1 (``tp_local``'s
banks hold this rank's ``E/tp`` experts): tokens are replicated over
'model', so every rank routes every token with the whole router, keeps
its experts' columns of dispatch and combine, runs its experts, and
returns its partial output for ``shard_act`` to sum (what GSPMD computes
from the reference's constraints on ``ein`` and ``h``). The experts'
input and the gates enter through ``to_model``, so their gradients (and
the router's, through the gates) come out whole on every rank; the
router's own input and the aux loss do not, as every rank computes them
whole.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.layers import _init_dense, linear

_ROUTES = threading.local()


@contextlib.contextmanager
def recording_routes():
    """Collect every routing's ``(T, K)`` expert indices on this thread,
    in call order, into the list it yields."""
    prev = getattr(_ROUTES, "log", None)
    _ROUTES.log = []
    try:
        yield _ROUTES.log
    finally:
        _ROUTES.log = prev


def init_moe(generator, d_model: int, d_ff: int, n_experts: int,
             kind: str = "swiglu", device=None) -> Dict:
    def bank(din, dout):
        w = torch.randn((n_experts, din, dout), generator=generator,
                        dtype=torch.float32, device=device)
        return {"w": w.mul_(1.0 / math.sqrt(din))}

    p = {"router": _init_dense(generator, d_model, n_experts, scale=0.02,
                               device=device),
         "wi": bank(d_model, d_ff)}
    if kind in ("swiglu", "geglu"):
        p["wg"] = bank(d_model, d_ff)
    p["wdown"] = bank(d_ff, d_model)
    return p


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``idx.shape + (n,)`` one-hot in ``dtype``; an index outside
    ``[0, n)`` gives a zero row (no host-side range check)."""
    return (idx.unsqueeze(-1) == torch.arange(n, device=idx.device)).to(dtype)


def expert_matmul(bank, x: torch.Tensor) -> torch.Tensor:
    """x: (E, C, din) @ bank → (E, C, dout): a dense ``(E, din, dout)``
    bank in the activation dtype, a quantized one through
    ``ops.expert_matmul`` (one dequant-matmul launch per expert on a CUDA
    tensor, the dequantized bank and ``torch.matmul`` on the CPU)."""
    w = bank.get("w")
    if torch.is_tensor(w):
        return torch.matmul(x, w.to(x.dtype))
    from repro_torch.kernels import ops                    # lazy import
    return ops.expert_matmul(x, bank)


def route(router, xt: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router probabilities (T, E) float32, and each token's ``top_k``
    renormalized gates and expert indices (T, K), largest first, ties to
    the lower index (as ``lax.top_k``)."""
    logits = linear(router, xt).to(torch.float32)
    # jax.nn.softmax's form: exp(x - max) / sum
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = u / u.sum(dim=-1, keepdim=True)
    # a stable descending sort keeps equal probabilities in index order
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    vals = vals / torch.clamp_min(vals.sum(dim=-1, keepdim=True), 1e-9)
    return probs, vals, idx


TOKEN_CHUNK = 8192   # dispatch-tensor bound: (chunk, E, C·chunk/T) per block


def moe_ffn(params, x: torch.Tensor, *, n_experts: int, top_k: int,
            kind: str = "swiglu", capacity_factor: float = 1.25,
            dropless: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, D).

    ``dropless=True`` sets capacity = tokens (no token is ever dropped):
    decode and verify, where capacity competition would make a row's result
    depend on its batch. Prefill and chunk use the GShard capacity, rounded
    up. Above ``2 * TOKEN_CHUNK`` routed tokens the sequence is routed in
    ``TOKEN_CHUNK`` blocks (capacity competition per block), as in the
    reference. ``aux_loss`` is the Switch load-balancing loss. Under a
    routing group the tokens counted are the group's, and under a 'model'
    axis above 1 the output is this rank's partial sum (see the module
    docstring)."""
    b, s, d = x.shape
    t = b * s
    routing = sharding.current_routing()
    nr = routing.size if routing is not None else 1
    tg = t * nr                          # the tokens routed together
    if tg > 2 * TOKEN_CHUNK and tg % TOKEN_CHUNK == 0 and s % (
            tg // TOKEN_CHUNK) == 0:
        nblk = tg // TOKEN_CHUNK
        xs = x.reshape(b, nblk, s // nblk, d).transpose(0, 1)
        outs = [moe_ffn(params, xs[i], n_experts=n_experts, top_k=top_k,
                        kind=kind, capacity_factor=capacity_factor,
                        dropless=dropless)
                for i in range(nblk)]
        ys = torch.stack([y for y, _ in outs]).transpose(0, 1)
        return ys.reshape(b, s, d), torch.stack([a for _, a in outs]).mean()
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(params["router"], xt, top_k)
    log = getattr(_ROUTES, "log", None)
    if log is not None:
        log.append(gate_idx.detach())

    if dropless:
        capacity = tg
    else:
        # GShard capacity rounds up (see the reference)
        capacity = max(1, math.ceil(tg * top_k * capacity_factor / n_experts))
        capacity = min(capacity, tg)

    # position of each (token, k) within its expert's capacity buffer
    onehot = _one_hot(gate_idx, n_experts, torch.int32)        # (T, K, E)
    flatoh = onehot.reshape(t * top_k, n_experts)
    pos = torch.cumsum(flatoh, dim=0)
    slots = capacity
    if routing is not None:
        # the ranks before this one fill each expert's buffer first; this
        # rank's buffer holds its own slots (at most t an expert)
        from repro_torch.distributed.group import routing_gather
        counts = routing_gather(flatoh.sum(0), routing)          # (R, E)
        first = counts[:routing.index].sum(0)
        pos = pos + first
        slots = min(capacity, t)
    pos = pos * flatoh - 1                                     # (T*K, E)
    pos = pos.reshape(t, top_k, n_experts)
    within = (pos * onehot).sum(-1)                            # (T, K)
    keep = (within < capacity) & (within >= 0)
    if routing is not None:
        within = within - first[gate_idx]                # this rank's slot

    # dispatch (T, E, C) / combine (T, E, C), accumulated over the K
    # routing slots, for this rank's experts (all of them without a
    # 'model' axis)
    e0, ne = sharding.local_experts(n_experts)
    gates = sharding.to_model(gate_vals)
    dt = x.dtype
    disp = torch.zeros((t, ne, slots), dtype=dt, device=x.device)
    comb = torch.zeros((t, ne, slots), dtype=dt, device=x.device)
    for kk in range(top_k):
        oh_e = _one_hot(gate_idx[:, kk] - e0, ne, dt)
        oh_c = _one_hot(torch.where(keep[:, kk], within[:, kk], slots),
                        slots + 1, dt)[..., :-1]
        d_k = oh_e[:, :, None] * oh_c[:, None, :] \
            * keep[:, kk, None, None].to(dt)
        disp = disp + d_k
        comb = comb + d_k * gates[:, kk, None, None].to(dt)

    ein = torch.einsum("tec,td->ecd", disp,
                       sharding.to_model(xt)).contiguous()     # (E, C, D)
    if kind in ("swiglu", "geglu"):
        gate = expert_matmul(params["wg"], ein)
        gate = F.silu(gate) if kind == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = gate * expert_matmul(params["wi"], ein)
    else:
        h = F.relu(expert_matmul(params["wi"], ein))
    out = expert_matmul(params["wdown"], h)           # (E, C, D)
    y = torch.einsum("tec,ecd->td", comb, out).reshape(b, s, d)

    # load-balancing aux loss (Switch): E · Σ_e f_e · p_e, whole on every
    # 'model' rank, over the routing group's tokens
    kept = ((onehot * keep[..., None]).sum(1) > 0).to(torch.float32)
    if routing is None:
        density, mean_prob = kept.mean(0), probs.mean(0)        # (E,)
    else:
        from repro_torch.distributed.group import routing_sum
        sums = routing_sum(torch.stack([kept.sum(0), probs.sum(0)]),
                           routing) / tg
        density, mean_prob = sums[0], sums[1]
    aux = n_experts * torch.sum(density * mean_prob)
    return y, aux
