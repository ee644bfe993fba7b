"""Feed-forward variants: SwiGLU (llama-family), GeGLU (gemma), ReLU/GELU.

Under tensor-parallel execution the hidden ``h`` is this rank's ``d_ff /
tp`` columns (column-parallel ``wi``/``wg``), and the row-parallel
``wdown`` product comes back as partial sums, which the block sums over
'model' (``models.transformer``)."""
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


def ffn(params, x: torch.Tensor, kind: str = "swiglu",
        lin=linear) -> torch.Tensor:
    """``lin``: the dense product (the verify forward passes one that runs
    position by position, ``layers.by_position``)."""
    if kind == "swiglu":
        h = F.silu(lin(params["wg"], x)) * lin(params["wi"], x)
    elif kind == "geglu":
        h = F.gelu(lin(params["wg"], x), approximate="tanh") * \
            lin(params["wi"], x)
    elif kind == "gelu":
        h = F.gelu(lin(params["wi"], x), approximate="tanh")
    else:  # relu
        h = F.relu(lin(params["wi"], x))
    return lin(params["wdown"], h)
