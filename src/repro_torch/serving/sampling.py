"""Token sampling: greedy / temperature / top-k."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) → (B,) int32. Greedy when ``temperature <= 0``;
    otherwise draws from ``generator`` (which must live on the logits'
    device)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32) / temperature
    if top_k > 0:
        vals, _ = torch.topk(lg, top_k, dim=-1)
        kth = vals[:, -1:]
        lg = torch.where(lg < kth, float("-inf"), lg)
    probs = torch.softmax(lg, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
