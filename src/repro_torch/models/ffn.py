"""Feed-forward variants: SwiGLU (llama-family), GeGLU (gemma), ReLU/GELU."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _init_dense, linear


def init_ffn(generator, d_model: int, d_ff: int, kind: str = "swiglu",
             device=None) -> Dict:
    if kind in ("swiglu", "geglu"):
        return {"wi": _init_dense(generator, d_model, d_ff, device=device),
                "wg": _init_dense(generator, d_model, d_ff, device=device),
                "wdown": _init_dense(generator, d_ff, d_model, device=device)}
    return {"wi": _init_dense(generator, d_model, d_ff, device=device),
            "wdown": _init_dense(generator, d_ff, d_model, device=device)}


def ffn(params, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(linear(params["wg"], x)) * linear(params["wi"], x)
    elif kind == "geglu":
        h = F.gelu(linear(params["wg"], x), approximate="tanh") * \
            linear(params["wi"], x)
    elif kind == "gelu":
        h = F.gelu(linear(params["wi"], x), approximate="tanh")
    else:  # relu
        h = F.relu(linear(params["wi"], x))
    return linear(params["wdown"], h)
