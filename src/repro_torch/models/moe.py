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
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_dense, linear


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
    up. Above ``2 * TOKEN_CHUNK`` tokens the sequence is routed in
    ``TOKEN_CHUNK`` blocks (capacity competition per block), as in the
    reference. ``aux_loss`` is the Switch load-balancing loss."""
    b, s, d = x.shape
    t = b * s
    if t > 2 * TOKEN_CHUNK and t % TOKEN_CHUNK == 0 and s % (
            t // TOKEN_CHUNK) == 0:
        nblk = t // TOKEN_CHUNK
        xs = x.reshape(b, nblk, s // nblk, d).transpose(0, 1)
        outs = [moe_ffn(params, xs[i], n_experts=n_experts, top_k=top_k,
                        kind=kind, capacity_factor=capacity_factor,
                        dropless=dropless)
                for i in range(nblk)]
        ys = torch.stack([y for y, _ in outs]).transpose(0, 1)
        return ys.reshape(b, s, d), torch.stack([a for _, a in outs]).mean()
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(params["router"], xt, top_k)

    if dropless:
        capacity = t
    else:
        # GShard capacity rounds up (see the reference)
        capacity = max(1, math.ceil(t * top_k * capacity_factor / n_experts))
        capacity = min(capacity, t)

    # position of each (token, k) within its expert's capacity buffer
    onehot = _one_hot(gate_idx, n_experts, torch.int32)        # (T, K, E)
    flatoh = onehot.reshape(t * top_k, n_experts)
    pos = torch.cumsum(flatoh, dim=0) * flatoh - 1             # (T*K, E)
    pos = pos.reshape(t, top_k, n_experts)
    within = (pos * onehot).sum(-1)                            # (T, K)
    keep = (within < capacity) & (within >= 0)

    # dispatch (T, E, C) / combine (T, E, C), accumulated over the K
    # routing slots
    dt = x.dtype
    disp = torch.zeros((t, n_experts, capacity), dtype=dt, device=x.device)
    comb = torch.zeros((t, n_experts, capacity), dtype=dt, device=x.device)
    for kk in range(top_k):
        oh_e = _one_hot(gate_idx[:, kk], n_experts, dt)
        oh_c = _one_hot(torch.where(keep[:, kk], within[:, kk], capacity),
                        capacity + 1, dt)[..., :-1]
        d_k = oh_e[:, :, None] * oh_c[:, None, :] \
            * keep[:, kk, None, None].to(dt)
        disp = disp + d_k
        comb = comb + d_k * gate_vals[:, kk, None, None].to(dt)

    ein = torch.einsum("tec,td->ecd", disp, xt).contiguous()   # (E, C, D)
    if kind in ("swiglu", "geglu"):
        gate = expert_matmul(params["wg"], ein)
        gate = F.silu(gate) if kind == "swiglu" else \
            F.gelu(gate, approximate="tanh")
        h = gate * expert_matmul(params["wi"], ein)
    else:
        h = F.relu(expert_matmul(params["wi"], ein))
    out = expert_matmul(params["wdown"], h)           # (E, C, D)
    y = torch.einsum("tec,ecd->td", comb, out).reshape(b, s, d)

    # load-balancing aux loss (Switch): E · Σ_e f_e · p_e
    density = (disp.sum(-1) > 0).to(torch.float32).mean(0)     # (E,)
    aux = n_experts * torch.sum(density * probs.mean(0))
    return y, aux
