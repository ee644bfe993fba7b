"""Mamba (S6 selective SSM) block — the Jamba hybrid's sequence mixer.

Train/prefill scans the diagonal SSM recurrence
h_t = a_t ⊙ h_{t-1} + b_t  (a_t = exp(Δ_t·A), b_t = Δ_t·B_t·x_t) within a
chunk by a Hillis-Steele doubling (``ceil(log2 C)`` steps of the
associative combine, the reference's ``lax.associative_scan``), the entry
state entering through the cumulative product of ``a``; longer sequences
loop over chunks carrying the state. Decode is a single-step state update.

Shapes follow mamba-1: d_inner = expand·d_model, depthwise causal conv
(d_conv), data-dependent Δ/B/C, learned A (d_inner, d_state) and D skip.
The mixer is torch ops (the reference's is jnp ops, not Pallas); its four
projections go through ``linear``, so a quantized tree runs them on the
dequant-matmul kernel.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_dense, linear


def init_mamba(generator, d_model: int, d_state: int = 16, d_conv: int = 4,
               expand: int = 2, dt_rank: Optional[int] = None,
               device=None) -> Dict:
    d_inner = expand * d_model
    dt_rank = dt_rank or max(1, d_model // 16)
    f32 = dict(dtype=torch.float32, device=device)
    a = torch.arange(1, d_state + 1, **f32)[None].repeat(d_inner, 1)
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((d_inner,), generator=generator, **f32) * (hi - lo) + lo
    return {
        "in_proj": _init_dense(generator, d_model, 2 * d_inner,
                               device=device),
        "conv_w": torch.randn((d_conv, d_inner), generator=generator,
                              **f32).mul_(1.0 / math.sqrt(d_conv)),
        "conv_b": torch.zeros((d_inner,), **f32),
        "x_proj": _init_dense(generator, d_inner, dt_rank + 2 * d_state,
                              device=device),
        "dt_proj": _init_dense(generator, dt_rank, d_inner, device=device),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))),
        "a_log": torch.log(a),
        "d_skip": torch.ones((d_inner,), **f32),
        "out_proj": _init_dense(generator, d_inner, d_model, device=device),
    }


def _ssm_inputs(params, xc: torch.Tensor, dt_rank: int, d_state: int):
    """xc: (..., d_inner) post-conv. Returns (a, bx, c) per position."""
    dbc = linear(params["x_proj"], xc)
    dt = dbc[..., :dt_rank]
    b = dbc[..., dt_rank:dt_rank + d_state]
    c = dbc[..., dt_rank + d_state:]
    dt = F.softplus(linear(params["dt_proj"], dt)
                    + params["dt_bias"].to(xc.dtype))
    a = -torch.exp(params["a_log"].to(torch.float32))           # (DI, N)
    a_t = torch.exp(dt[..., None].to(torch.float32) * a)        # (..., DI, N)
    bx = (dt * xc)[..., None].to(torch.float32) * \
        b[..., None, :].to(torch.float32)                       # (..., DI, N)
    return a_t, bx, c


def _conv_train(params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, DI)."""
    d_conv = params["conv_w"].shape[0]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    out = sum(xp[:, i:i + x.shape[1], :] *
              params["conv_w"][i][None, None].to(x.dtype)
              for i in range(d_conv))
    return out + params["conv_b"].to(x.dtype)


def _assoc_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the combine
    ``(a_l, b_l), (a_r, b_r) -> (a_l·a_r, b_r + a_r·b_l)`` by Hillis-Steele
    doubling: after the step of span ``k`` position ``i`` holds the
    combination of positions ``i-2k+1 .. i``."""
    span = 1
    while span < a.shape[1]:
        al, bl = a[:, :-span], b[:, :-span]
        ar, br = a[:, span:], b[:, span:]
        a = torch.cat([a[:, :span], al * ar], dim=1)
        b = torch.cat([b[:, :span], br + ar * bl], dim=1)
        span *= 2
    return a, b


def _chunk_scan(a_t: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t·h_{t-1} + bx_t over one chunk, given entry state h0.

    a_t, bx: (B, C, DI, N); h0: (B, DI, N). The scan within the chunk plus
    the h0 contribution, decayed by the cumulative product of ``a`` (a
    plain product, as the reference's ``jnp.cumprod``). Returns
    (h_all (B, C, DI, N), h_last)."""
    _, h = _assoc_scan(a_t, bx)
    cum = torch.cumprod(a_t, dim=1)
    h = h + cum * h0[:, None]
    return h, h[:, -1]


def _ssm_out(h_all: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y[b, s, d] = Σ_n h[b, s, d, n]·c[b, s, n] in float32."""
    return torch.einsum("bsdn,bsn->bsd", h_all, c.to(torch.float32))


def mamba(params, x: torch.Tensor, *, d_state: int = 16,
          state: Optional[Dict] = None, mode: str = "train",
          chunk: int = 512, dt_rank: Optional[int] = None
          ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, D) for train/prefill/chunk; (B, 1, D) for decode.

    Train/prefill processes a sequence longer than ``chunk`` that it
    divides in ``chunk``-sized pieces, carrying the state, so the
    (B, C, DI, N) state tensor, not (B, S, DI, N), bounds the working set.
    ``dt_rank`` defaults to the dense ``dt_proj`` kernel's input width (the
    reference's reading); a quantized kernel stores (out, in), so the
    stack passes it from the config.
    """
    b, s, d = x.shape
    d_inner = params["dt_bias"].shape[0]
    if dt_rank is None:
        dt_rank = params["dt_proj"]["w"].shape[0]
    xz = linear(params["in_proj"], x)
    xr, z = xz[..., :d_inner], xz[..., d_inner:]
    d_conv = params["conv_w"].shape[0]

    if mode in ("train", "prefill"):
        xc = F.silu(_conv_train(params, xr))
        h_last = torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                             device=x.device)
        if s > chunk and s % chunk == 0:
            ys = []
            for c0 in range(0, s, chunk):
                a_t, bx, c = _ssm_inputs(params, xc[:, c0:c0 + chunk],
                                         dt_rank, d_state)
                h_all, h_last = _chunk_scan(a_t, bx, h_last)
                ys.append(_ssm_out(h_all, c).to(x.dtype))
            y = torch.cat(ys, dim=1)
        else:
            a_t, bx, c = _ssm_inputs(params, xc, dt_rank, d_state)
            h_all, h_last = _chunk_scan(a_t, bx, h_last)
            y = _ssm_out(h_all, c)
        y = y.to(x.dtype) + xc * params["d_skip"].to(x.dtype)
        new_state = None
        if mode == "prefill":
            new_state = {"h": h_last,                           # (B, DI, N)
                         "conv": xr[:, -(d_conv - 1):, :]}
    elif mode == "chunk":
        # partial-prefill continuation: the depthwise conv reads its left
        # context from the carried ``conv`` tail instead of zero padding,
        # and the scan enters at the carried ``h`` (the monolithic prefill
        # up to float reassociation: the "mamba" agreement budget)
        xp = torch.cat([state["conv"].to(xr.dtype), xr], dim=1)
        conv = sum(xp[:, i:i + s, :] *
                   params["conv_w"][i][None, None].to(xr.dtype)
                   for i in range(d_conv))
        xc = F.silu(conv + params["conv_b"].to(xr.dtype))
        a_t, bx, c = _ssm_inputs(params, xc, dt_rank, d_state)
        h_all, h_last = _chunk_scan(a_t, bx, state["h"])
        y = _ssm_out(h_all, c)
        y = y.to(x.dtype) + xc * params["d_skip"].to(x.dtype)
        new_state = {"h": h_last, "conv": xp[:, s:, :].to(torch.float32)}
    else:  # decode: one token
        # the reference's concatenate promotes: a float32 tail (the pool's)
        # keeps the buffer float32, a prefill's activation-dtype tail (the
        # round scheduler's cache) keeps it in that dtype
        dt = torch.promote_types(state["conv"].dtype, xr.dtype)
        conv_buf = torch.cat([state["conv"].to(dt), xr.to(dt)],
                             dim=1)                              # (B, dc, DI)
        xc = torch.einsum("bcd,cd->bd", conv_buf.to(torch.float32),
                          params["conv_w"].to(torch.float32))
        xc = F.silu(xc + params["conv_b"]).to(x.dtype)[:, None]
        a_t, bx, c = _ssm_inputs(params, xc, dt_rank, d_state)
        h = a_t[:, 0] * state["h"] + bx[:, 0]                    # (B, DI, N)
        y = torch.einsum("bdn,bn->bd", h, c[:, 0].to(torch.float32))
        y = y[:, None].to(x.dtype) + xc * params["d_skip"].to(x.dtype)
        new_state = {"h": h, "conv": conv_buf[:, 1:]}

    out = F.silu(z) * y
    return linear(params["out_proj"], out), new_state


def init_mamba_state(batch: int, d_model: int, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2, device=None) -> Dict:
    d_inner = expand * d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d_inner, d_state), **f32),
            "conv": torch.zeros((batch, d_conv - 1, d_inner), **f32)}
