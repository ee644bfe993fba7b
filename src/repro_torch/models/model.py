"""Model builder: ArchConfig → init / forward / prefill / decode_step.

The returned ``LM`` object is the single interface used by the serving
engine and the quantization pipeline. Inference only (``torch.no_grad``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (init_embedding, init_norm, linear,
                                       rms_norm)
from repro_torch.models.transformer import (_rope_dim, apply_stack,
                                            init_cache, init_stack,
                                            layer_plan, rope_values)


def arch_features(cfg) -> Tuple[str, ...]:
    """Sequence-mixer features beyond a plain-attention dense stack (the keys
    of the reference package's agreement budgets). An empty tuple means a
    plain-attention dense stack — the only kind this package serves so far."""
    plan = layer_plan(cfg)
    feats = []
    if cfg.mla is not None:
        feats.append("mla")
    if cfg.window:
        feats.append("sliding_window")
    if any(moe for _, moe in plan):
        feats.append("moe")
    if any(kind == "m" for kind, _ in plan):
        feats.append("mamba")
    if any(kind == "rwkv" for kind, _ in plan):
        feats.append("rwkv")
    return tuple(feats)


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class LM:
    cfg: Any

    # ----------------------------------------------------------------- init
    def init(self, generator: torch.Generator, device=None) -> Dict[str, Any]:
        """Random parameters from ``generator`` (which must live on
        ``device``; default: the CUDA device). Shapes, dtypes and standard
        deviations follow the reference package's init: dense kernels are
        float32 with std 1/sqrt(d_in), the embedding (and an untied head) is
        in the config's dtype with std 0.02. The numbers are torch's own."""
        device = torch.device("cuda" if device is None else device)
        if self.cfg.is_encdec:
            raise NotImplementedError("not ported yet: encoder-decoder models")
        dt = _dtype(self.cfg)
        p = {"embedding": init_embedding(generator, self.cfg.vocab,
                                         self.cfg.d_model, dt, device=device),
             "stack": init_stack(generator, self.cfg, device=device),
             "final_norm": init_norm(self.cfg.d_model,
                                     plus_one=self.cfg.norm_plus_one,
                                     device=device)}
        if not self.cfg.tie_embeddings:
            w = torch.randn((self.cfg.d_model, self.cfg.vocab),
                            generator=generator, dtype=dt, device=device)
            p["lm_head"] = {"w": w.mul_(0.02)}
        return p

    # ------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        x = params["embedding"]["embedding"][tokens]
        if self.cfg.emb_scale:
            x = x * torch.tensor(math.sqrt(float(self.cfg.d_model)),
                                 dtype=torch.float32).to(x.dtype)
        return x

    def _logits(self, params, x):
        x = rms_norm(params["final_norm"], x, plus_one=self.cfg.norm_plus_one)
        if self.cfg.tie_embeddings:
            w = params["embedding"]["embedding"]
            return x @ w.T.to(x.dtype)
        return linear(params["lm_head"], x)

    @torch.no_grad()
    def forward(self, params, batch, mode: str = "prefill",
                caches: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        tokens = batch["tokens"]
        b, s = tokens.shape
        if caches is not None and caches.get("block_tables") is not None:
            raise NotImplementedError("not ported yet: paged KV caches")
        if mode == "decode":
            pos = caches["pos"]
            positions = torch.tensor([pos], device=tokens.device)
        elif mode in ("train", "prefill"):
            pos = 0
            positions = torch.arange(s, device=tokens.device)
        else:
            raise NotImplementedError(f"not ported yet: forward mode {mode!r}")
        rope = rope_values(positions, _rope_dim(self.cfg),
                           self.cfg.rope_theta)
        x = self._embed(params, tokens)
        x, new_caches = apply_stack(params["stack"], x, cfg=self.cfg,
                                    rope=rope, mode=mode, caches=caches,
                                    pos=pos)
        if new_caches is not None:
            new_caches["pos"] = pos + s
        return self._logits(params, x), new_caches

    # --------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, quantize_kv: bool = False,
                   device=None) -> dict:
        device = torch.device("cuda" if device is None else device)
        return init_cache(self.cfg, batch, max_len, quantize_kv,
                          _dtype(self.cfg), device=device)

    def prefill(self, params, batch, caches) -> Tuple[torch.Tensor, dict]:
        logits, caches = self.forward(params, batch, mode="prefill",
                                      caches=caches)
        return logits[:, -1], caches

    def decode_step(self, params, tokens, caches
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (B, 1) — one new token per sequence."""
        logits, caches = self.forward(params, {"tokens": tokens},
                                      mode="decode", caches=caches)
        return logits[:, -1], caches

    def prefill_chunk(self, params, batch, caches):
        raise NotImplementedError("not ported yet: chunked prefill")

    def verify_step(self, params, tokens, caches):
        raise NotImplementedError("not ported yet: speculative verify")

    def arch_features(self) -> Tuple[str, ...]:
        """See :func:`arch_features`."""
        return arch_features(self.cfg)


def build_model(cfg) -> LM:
    return LM(cfg=cfg)
