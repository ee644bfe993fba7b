"""Assigned input shapes (one set shared by all 10 LM-family archs).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``. ``long_500k`` requires sub-quadratic
sequence mixing — it runs only for archs with ``sub_quadratic=True``
(jamba / rwkv6 / mixtral-SWA); pure full-attention archs skip it (recorded
as N/A in EXPERIMENTS.md, rationale in DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cells(cfgs) -> List[Tuple[str, str, str]]:
    """All (arch, shape, status) cells; status 'run' or 'skip:<reason>'."""
    out = []
    for cfg in cfgs:
        for name, sh in SHAPES.items():
            status = "run"
            if name == "long_500k" and not cfg.sub_quadratic:
                status = "skip:full-attention (O(S) dense KV at 512k)"
            out.append((cfg.name, name, status))
    return out
