"""RWKV-6 ("Finch") block: attention-free time mix with data-dependent
per-channel decay, plus the squared-ReLU channel mix.

Two equivalent sequence-mix implementations, as in the reference package:

* ``wkv_scan``    — per-step recurrence (the oracle; also the decode path).
* ``wkv_chunked`` — chunkwise-parallel form: intra-chunk products plus one
  state carry per chunk (a Python loop over the chunks). Per-channel
  log-decays factorize the inter-position decay exp(b_{i-1} − b_j) into q·k
  form; with the per-step log-decay clamped to ≥ −2 and chunk 32 every
  intermediate stays finite in float32.

Recurrence per head (state S: (D_k, D_v)):
    o_t = r_t · (S_{t-1} + diag(u)·k_tᵀ v_t)
    S_t = diag(w_t)·S_{t-1} + k_tᵀ v_t

Neither form is a hand-written kernel: they are torch ops (the reference's
are jnp ops, not Pallas). The projections go through ``linear``, so a
quantized tree runs them on the dequant-matmul kernel.

Tensor-parallel over 'model' (``distributed.sharding``), as the
reference's rules cut the tree: the time mix runs this rank's heads
(``wr`` / ``wk`` / ``wv`` / ``wg`` column-parallel, the head count read
off ``wr``'s local width, ``wo`` row-parallel: the block sums its partial
output) on a wkv state of its heads. The decay LoRA is replicated, so
``w_raw`` is whole on every rank and each takes its channels; ``u``,
``w0``, the lerp factors and the LoRA's kernels enter through ``to_model``
(each rank uses them in part, so their gradients are summed over 'model'
once). ``ln_x`` normalizes a whole ``d_model`` row that the heads cut: the
row's sum of squares is summed over 'model' forward and backward
(``sharding.model_sum``), a ``(B, S, 1)`` collective. The channel mix's
``wk`` is column-parallel and ``wv`` row-parallel, summed here; ``wr``,
column-parallel by the rules, is gathered whole (``gather_cols``) before
its sigmoid multiplies the sum, so the channel mix returns its output
whole. The token-shift rows stay whole.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (gather_cols, local_slice,
                                              model_axis, model_sum,
                                              shard_act, to_model)
from repro_torch.models.layers import _init_dense, init_norm, linear, rms_norm
from repro_torch.quant.qtypes import QuantizedTensor

LOG_W_MIN = -2.0   # per-step log-decay clamp (see module docstring)


def init_rwkv_timemix(generator, d_model: int, head_dim: int = 64,
                      decay_lora: int = 64, device=None) -> Dict:
    h = d_model // head_dim

    def dense(din, dout, scale=None):
        return _init_dense(generator, din, dout, scale=scale, device=device)

    def full(v):
        return torch.full((d_model,), v, dtype=torch.float32, device=device)

    return {
        # the decay stream's lerp factor is keyed "d", not "w": "w" names
        # matmul kernels (the quantizer quantizes every "w")
        "mu": {s: full(0.5) for s in ("r", "k", "v", "g", "d")},
        "wr": dense(d_model, d_model),
        "wk": dense(d_model, d_model),
        "wv": dense(d_model, d_model),
        "wg": dense(d_model, d_model),
        "w_lora_a": dense(d_model, decay_lora, 0.01),
        "w_lora_b": dense(decay_lora, d_model, 0.01),
        "w0": full(-1.0),
        "u": torch.randn((h, head_dim), generator=generator,
                         dtype=torch.float32, device=device).mul_(0.1),
        "ln_x": init_norm(d_model, device=device),
        "wo": dense(d_model, d_model),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Shift right by one; position 0 sees ``x_prev`` (zeros at seq start)."""
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _used_in_part(node):
    """A replicated leaf (or dense kernel's node) that each 'model' rank
    uses in part, through ``to_model``; a quantized kernel (no gradient)
    as it is."""
    if isinstance(node, torch.Tensor):
        return to_model(node)
    w = node.get("w")
    if isinstance(w, torch.Tensor) and not isinstance(w, QuantizedTensor):
        return dict(node, w=to_model(w))
    return node


def _mix_streams(p, x: torch.Tensor, xx: torch.Tensor) -> Dict:
    """RWKV6-style data-dependent lerp for the five streams."""
    dx = xx - x
    mu = {s: _used_in_part(v).to(x.dtype) for s, v in p["mu"].items()}
    outs = {s: x + dx * mu[s] for s in ("r", "k", "v", "g")}
    outs["w"] = x + dx * mu["d"]
    # decay gets the extra data-dependent LoRA term (the "Finch" novelty)
    lora = torch.tanh(linear(_used_in_part(p["w_lora_a"]), outs["w"]))
    outs["w_raw"] = _used_in_part(p["w0"]).to(x.dtype) + \
        linear(_used_in_part(p["w_lora_b"]), lora)
    return outs


def _ln_x(p, o: torch.Tensor, width: int, eps: float = 1e-6
          ) -> torch.Tensor:
    """``ln_x``: a plain RMSNorm over the ``width`` channels of ``o``'s
    rows; under 'model' ``o`` holds this rank's channels, and the rows'
    sum of squares is summed over the ranks (``rms_norm``'s arithmetic
    otherwise)."""
    if o.shape[-1] == width:
        return rms_norm(p, o, eps)
    dt = o.dtype
    of = o.to(torch.float32)
    var = model_sum((of * of).sum(dim=-1, keepdim=True)) / width
    g = local_slice(p["gain"], o.shape[-1]).to(torch.float32)
    return (of * torch.rsqrt(var + eps) * g).to(dt)


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, d // head_dim, head_dim).transpose(1, 2)


def wkv_scan(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle/decode path. r/k/v/logw: (B, H, S, D); u: (H, D);
    s0: (B, H, D, D). Returns (o (B, H, S, D), s_final)."""
    s = s0
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, lwt = r[:, :, t], k[:, :, t], v[:, :, t], logw[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]             # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhdn->bhn", rt,
                                 s + u[None, :, :, None] * kv))
        s = torch.exp(lwt)[..., None] * s + kv
    return torch.stack(outs, dim=2), s


def wkv_chunked(r, k, v, logw, u, s0, chunk: int = 32
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunkwise-parallel WKV. Same signature as :func:`wkv_scan`."""
    s = r.shape[2]
    assert s % chunk == 0, f"seq {s} % chunk {chunk}"
    ii = torch.arange(chunk, device=r.device)
    strict = ii[:, None] > ii[None, :]
    state = s0
    outs = []
    for c0 in range(0, s, chunk):
        rc, kc, vc, lwc = (a[:, :, c0:c0 + chunk] for a in (r, k, v, logw))
        bcs = torch.cumsum(lwc, dim=2)                       # inclusive b_i
        b_prev = bcs - lwc                                   # b_{i-1}
        q = rc * torch.exp(b_prev)
        o_inter = torch.einsum("bhid,bhdn->bhin", q, state)
        kx = kc * torch.exp(-bcs)
        att = torch.einsum("bhid,bhjd->bhij", q, kx)
        att = torch.where(strict, att, torch.zeros((), dtype=att.dtype,
                                                   device=att.device))
        o_intra = torch.einsum("bhij,bhjn->bhin", att, vc)
        cdiag = torch.einsum("bhid,hd,bhid->bhi", rc, u, kc)
        outs.append(o_inter + o_intra + cdiag[..., None] * vc)
        kz = kc * torch.exp(bcs[:, :, -1:, :] - bcs)
        state = torch.exp(bcs[:, :, -1, :])[..., None] * state + \
            torch.einsum("bhjd,bhjn->bhdn", kz, vc)
    return torch.cat(outs, dim=2), state


def rwkv_timemix(p, x: torch.Tensor, *, head_dim: int = 64,
                 state: Optional[Dict] = None, mode: str = "train",
                 chunk: int = 32) -> Tuple[torch.Tensor, Optional[Dict]]:
    b, s, d = x.shape
    # train/prefill start a sequence: the entry state is zeros by definition
    # (prefill must not read a cache's stale state). "chunk" is the prefill
    # continuation: it folds the carried token-shift row and wkv state
    # across the chunk boundary, the monolithic recurrence up to float
    # reassociation of the scan grouping (the "rwkv" agreement budget)
    seq_start = mode in ("train", "prefill") or state is None
    x_prev = torch.zeros_like(x[:, 0]) if seq_start \
        else state["x_tm"].to(x.dtype)
    xx = _token_shift(x, x_prev)
    mix = _mix_streams(p, x, xx)
    r = linear(p["wr"], mix["r"])
    dl = r.shape[-1]                         # this rank's heads' channels
    h = dl // head_dim
    r = _heads(r, head_dim)
    k = _heads(linear(p["wk"], mix["k"]), head_dim)
    v = _heads(linear(p["wv"], mix["v"]), head_dim)
    g = F.silu(linear(p["wg"], mix["g"]))
    # w_raw is whole on every rank (the LoRA is replicated): this rank's
    # channels, the LoRA's leaves carrying the gradient (_used_in_part)
    k0 = model_axis()[1] * dl
    logw = torch.clamp(-torch.exp(mix["w_raw"][..., k0:k0 + dl].to(
        torch.float32)), LOG_W_MIN, -1e-4)
    logw = _heads(logw, head_dim)
    u = local_slice(p["u"], h).to(torch.float32)

    s0 = torch.zeros((b, h, head_dim, head_dim), dtype=torch.float32,
                     device=x.device) if seq_start else state["wkv"]
    rf, kf, vf = (a.to(torch.float32) for a in (r, k, v))
    if mode == "decode" or s == 1 or s % chunk:
        o, s_fin = wkv_scan(rf, kf, vf, logw, u, s0)
    else:
        o, s_fin = wkv_chunked(rf, kf, vf, logw, u, s0, chunk)
    o = o.transpose(1, 2).reshape(b, s, dl).to(x.dtype)
    # ln_x is a plain RMSNorm whatever the stack's norm_plus_one says
    o = _ln_x(p["ln_x"], o, d) * g
    out = linear(p["wo"], o)
    new_state = None
    if mode in ("prefill", "decode", "chunk"):
        new_state = {"x_tm": x[:, -1], "wkv": s_fin}
    return out, new_state


def init_rwkv_channelmix(generator, d_model: int, d_ff: int,
                         device=None) -> Dict:
    return {
        "mu": {s: torch.full((d_model,), 0.5, dtype=torch.float32,
                             device=device) for s in ("k", "r")},
        "wk": _init_dense(generator, d_model, d_ff, device=device),
        "wv": _init_dense(generator, d_ff, d_model, device=device),
        "wr": _init_dense(generator, d_model, d_model, device=device),
    }


def rwkv_channelmix(p, x: torch.Tensor, *, state: Optional[Dict] = None,
                    mode: str = "train"
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    seq_start = mode in ("train", "prefill") or state is None
    x_prev = torch.zeros_like(x[:, 0]) if seq_start \
        else state["x_cm"].to(x.dtype)
    xx = _token_shift(x, x_prev)
    dx = xx - x
    xk = x + dx * _used_in_part(p["mu"]["k"]).to(x.dtype)
    xr = x + dx * _used_in_part(p["mu"]["r"]).to(x.dtype)
    kk = torch.square(F.relu(linear(p["wk"], xk)))
    # under 'model': wv's partial sums summed, wr's columns gathered whole
    out = torch.sigmoid(gather_cols(linear(p["wr"], xr), x.shape[-1])) * \
        shard_act(linear(p["wv"], kk))
    new_state = {"x_cm": x[:, -1]} \
        if mode in ("prefill", "decode", "chunk") else None
    return out, new_state
