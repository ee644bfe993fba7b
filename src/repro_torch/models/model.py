"""Model builder: ArchConfig → init / train_loss / prefill / decode_step.

The returned ``LM`` object is the single interface used by the trainer, the
serving engine and the quantization pipeline. ``forward(mode="train")`` and
``train_loss`` record autograd; every serving mode runs under
``torch.no_grad``.

Under ``distributed.sharding.activate_mesh`` with a 'model' axis above 1
the forward runs tensor-parallel on this rank's local tree
(``sharding.tp_local``): a vocab-parallel embedding and head where 'model'
divides the vocabulary, the logits gathered whole before the loss, a
cache (or sliding-window ring) of this rank's KV heads (its replica
group's where 'model' does not divide them), an MLA stack's
whole compressed cache, or a mamba or rwkv state of this rank's channels
or heads (:meth:`LM.init_cache`), an MoE layer on this rank's experts or,
where 'model' does not divide them, on every expert's share of its FFN
columns (``models.moe``), and an encoder-decoder's encoder and
cross-attention on this rank's heads over an encoder output (and a
cache's ``enc_out``) whole on every rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding
from repro_torch.models.layers import (by_position, embed, init_embedding,
                                       init_norm, linear, rms_norm)
from repro_torch.models.transformer import (_rope_dim, apply_encoder,
                                            apply_stack, init_cache,
                                            init_encoder, init_stack,
                                            layer_plan, rope_values)


def arch_features(cfg) -> Tuple[str, ...]:
    """Sequence-mixer features that make chunked prefill
    tolerance-equivalent (rather than bit-identical) to the monolithic path:
    the keys of ``serving.equivalence.AGREEMENT_BUDGETS`` ("mla",
    "sliding_window", "moe", "mamba", "rwkv"), composed multiplicatively
    there when features stack. An empty tuple means a plain-attention dense
    stack whose chunked prefill is exact."""
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


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy in float32 over the positions whose label is
    ``>= 0``: logsumexp minus the label's logit (a gather, equal to the
    reference's one-hot dot: every other term of that dot is an exact
    zero)."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.clamp_min(0).to(torch.int64)[..., None]
                      )[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum((lse - ll) * mask) / torch.clamp_min(mask.sum(), 1.0)


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
        in the config's dtype with std 0.02. The numbers are torch's own.
        An encoder-decoder config adds the ``encoder`` subtree
        (``transformer.init_encoder``)."""
        device = torch.device("cuda" if device is None else device)
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
        if self.cfg.is_encdec:
            p["encoder"] = init_encoder(generator, self.cfg, device=device)
        return p

    # ------------------------------------------------------------- forward
    def _embed(self, params, tokens):
        x = embed(params["embedding"], tokens, self.cfg.vocab)
        if self.cfg.emb_scale:
            x = x * torch.tensor(math.sqrt(float(self.cfg.d_model)),
                                 dtype=torch.float32).to(x.dtype)
        return x

    def _logits(self, params, x):
        x = rms_norm(params["final_norm"], x, plus_one=self.cfg.norm_plus_one)
        if sharding.vocab_parallel(self.cfg.vocab):
            x = sharding.to_model(x)
        if self.cfg.tie_embeddings:
            w = params["embedding"]["embedding"]
            logits = x @ w.T.to(x.dtype)
        else:
            logits = linear(params["lm_head"], x)
        return sharding.shard_logits(logits, self.cfg.vocab)

    def _encode(self, params, batch):
        """The encoder output of ``batch["enc_frames"]`` (None for a
        decoder-only model)."""
        if not self.cfg.is_encdec:
            return None
        return apply_encoder(params["encoder"], batch["enc_frames"],
                             cfg=self.cfg)

    def forward(self, params, batch, mode: str = "prefill",
                caches: Optional[dict] = None
                ) -> Tuple[torch.Tensor, Optional[dict]]:
        """(logits, new_caches). ``mode="train"`` (no cache) records
        autograd; the serving modes run under ``torch.no_grad``. An
        encoder-decoder model attends over ``batch["enc_out"]`` if given,
        else encodes ``batch["enc_frames"]``; the new caches carry the
        encoder output (``"enc_out"``) for the decode steps."""
        if mode == "train":
            return self._forward(params, batch, mode)[:2]
        with torch.no_grad():
            return self._forward(params, batch, mode, caches)[:2]

    def _forward(self, params, batch, mode: str,
                 caches: Optional[dict] = None):
        """(logits, new_caches, moe_aux); ``moe_aux`` is None outside train
        mode."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        if sharding.model_axis()[0] > 1:
            sharding.check_tensor_parallel(self.cfg, sharding.current_mesh())
            if mode == "verify" or caches is not None and \
                    "block_tables" in caches:
                raise NotImplementedError(sharding.tp_not_ported(
                    "speculative verify and the paged KV layout"))
        block_tables = caches.get("block_tables") \
            if caches is not None else None
        if mode == "decode":
            pos = caches["pos"]
            # a contiguous cache keeps ONE integer clock for the whole batch
            # (or, the drafter's, a per-row position vector); paged caches
            # keep a per-slot position vector on the device, so each row
            # gets its own absolute position (rope shapes follow)
            if isinstance(pos, int):
                positions = torch.tensor([pos], device=tokens.device)
            else:
                positions = pos[:, None]
        elif mode == "chunk":
            # partial-prefill continuation: the cache clock is the chunk's
            # start offset; rows live at absolute positions pos..pos+s-1. A
            # host integer is bounds-checked here; a 0-d device tensor (a
            # captured forward's clock) by the caller that filled it
            pos = caches["pos"]
            attn = [f"b{i}" for i, (kind, _) in
                    enumerate(layer_plan(self.cfg)) if kind == "a"]
            if isinstance(pos, int) and not self.cfg.window and attn:
                # a ring takes a chunk at any clock (it wraps); recurrent
                # state has no positions to overrun
                layer = caches["list"][0][attn[0]]
                self.check_chunk(pos, s, next(iter(layer.values())).shape[1])
            positions = pos + torch.arange(s, device=tokens.device)
        elif mode == "verify":
            # speculative multi-position verify on the paged cache: row
            # (b, j) sits at absolute position pos[b] + j
            pos = caches["pos"]
        elif mode in ("train", "prefill"):
            pos = 0
            positions = torch.arange(s, device=tokens.device)
        else:
            raise NotImplementedError(f"not ported yet: forward mode {mode!r}")
        if mode == "verify":
            # the rotary tables position by position, each a decode step's
            # (B, 1) computation (the CPU's vectorized and scalar cos/sin
            # may differ in the last bit, and which elements take which
            # depends on the tensor's size)
            tables = [rope_values(pos[:, None] + j, _rope_dim(self.cfg),
                                  self.cfg.rope_theta) for j in range(s)]
            rope = tuple(torch.cat(t, dim=1) for t in zip(*tables))
        else:
            rope = rope_values(positions, _rope_dim(self.cfg),
                               self.cfg.rope_theta)
        x = self._embed(params, tokens)
        enc_out = batch.get("enc_out")
        if enc_out is None:
            enc_out = self._encode(params, batch)
        # under 'model' every cross-attention projects this rank's K/V
        # heads from the whole encoder output: its gradient is summed over
        # 'model' once, after every layer's part
        x, new_caches, aux = apply_stack(
            params["stack"], x, cfg=self.cfg, rope=rope, mode=mode,
            caches=caches, pos=pos, block_tables=block_tables,
            enc_out=None if enc_out is None else sharding.to_model(enc_out))
        if new_caches is not None:
            new_caches["pos"] = pos + s
            if block_tables is not None:
                new_caches["block_tables"] = block_tables
            if enc_out is not None:
                new_caches["enc_out"] = enc_out
        if mode == "verify":
            # the final norm and the logits product (cuBLAS under a tied
            # embedding) position by position, as decode runs them
            return by_position(lambda t: self._logits(params, t), x), \
                new_caches, aux
        return self._logits(params, x), new_caches, aux

    # --------------------------------------------------------------- train
    def train_loss(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """``(xent + 0.01 * moe_aux, {"xent", "moe_aux"})`` of ``batch``
        (``tokens`` and ``labels``, labels ``< 0`` masked; an
        encoder-decoder's ``enc_frames`` too), with autograd."""
        logits, _, aux = self._forward(params, batch, "train")
        loss = _xent(logits, batch["labels"])
        return loss + 0.01 * aux, {"xent": loss, "moe_aux": aux}

    # --------------------------------------------------------------- serve
    def init_cache(self, batch: int, max_len: int, quantize_kv: bool = False,
                   device=None) -> dict:
        """The stack's caches at the clock 0 (under an active 'model' axis
        above 1, of this rank's KV heads); an encoder-decoder's also
        ``"enc_out"``, zeros of ``(batch, max(1, max_len // enc_ratio),
        d_model)`` in the model dtype (a prefill replaces it with the
        encoder output it computed, in that output's dtype), whole on
        every 'model' rank, as the reference's cache rule keeps it."""
        device = torch.device("cuda" if device is None else device)
        dt = _dtype(self.cfg)
        c = init_cache(self.cfg, batch, max_len, quantize_kv, dt,
                       device=device)
        if self.cfg.is_encdec:
            enc_len = max(1, max_len // self.cfg.enc_ratio)
            c["enc_out"] = torch.zeros((batch, enc_len, self.cfg.d_model),
                                       dtype=dt, device=device)
        return c

    def prefill(self, params, batch, caches) -> Tuple[torch.Tensor, dict]:
        logits, caches = self.forward(params, batch, mode="prefill",
                                      caches=caches)
        return logits[:, -1], caches

    def decode_step(self, params, tokens, caches
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (B, 1) — one new token per sequence (over the cache's
        ``enc_out`` for an encoder-decoder: cross K/V are recomputed from it
        every step, as in the reference)."""
        logits, caches = self.forward(
            params, {"tokens": tokens, "enc_out": caches.get("enc_out")},
            mode="decode", caches=caches)
        return logits[:, -1], caches

    def chunk_rows(self, s: int) -> int:
        """Cache rows a :meth:`prefill_chunk` of ``s`` tokens writes: a
        singleton is padded to two rows where the stack allows it."""
        pad_ok = not any(f in ("moe", "mamba", "rwkv")
                         for f in arch_features(self.cfg))
        return 2 if s == 1 and pad_ok else s

    @staticmethod
    def check_chunk(pos: int, rows: int, max_len: int) -> None:
        """The host's bounds check of a chunk writing ``rows`` cache rows at
        the integer clock ``pos`` (ValueError past ``max_len``)."""
        if pos < 0 or pos + rows > max_len:
            raise ValueError(f"cache write [{pos}, {pos + rows}) exceeds the "
                             f"cache length {max_len}")

    def prefill_chunk(self, params, batch, caches
                      ) -> Tuple[torch.Tensor, dict]:
        """Consume the next ``s`` prompt tokens of a partial prefill.

        ``caches["pos"]`` (an integer, or a 0-d int64 device tensor that
        the caller filled after :meth:`check_chunk`) is the chunk's start
        offset; the chunk attends over the already-written cache prefix
        plus itself, so feeding a prompt through this in any chunk split
        gives the cache and last-token logits of one :meth:`prefill` call.
        Single-token chunks are padded to two rows, as in the reference: a
        one-row product may take another summation order than the
        monolithic prefill's (here: the dequant-matmul kernel's
        weight-streaming variant), and the dummy row, whose cache write
        lands one past the clock, is overwritten before any read that is
        not masked."""
        toks = batch["tokens"]
        singleton = self.chunk_rows(toks.shape[1]) != toks.shape[1]
        if singleton:
            p0 = caches["pos"]
            toks = torch.cat([toks, toks[:, -1:]], dim=1)
        logits, caches = self.forward(params, {"tokens": toks}, mode="chunk",
                                      caches=caches)
        if singleton:
            caches["pos"] = p0 + 1
            return logits[:, 0], caches
        return logits[:, -1], caches

    def verify_step(self, params, tokens, caches
                    ) -> Tuple[torch.Tensor, dict]:
        """tokens: (B, S) — S-token runs written and scored at per-slot
        absolute positions ``pos[b] .. pos[b]+S-1`` on the paged cache.

        Returns ALL S per-position logits ``(B, S, vocab)``: row ``j``
        conditions on everything through position ``pos[b]+j`` and is bit
        for bit the logits a decode step at that position gives (every
        row-count-dependent call runs on the B rows of one position, see
        attention's verify mode)."""
        return self.forward(
            params, {"tokens": tokens, "enc_out": caches.get("enc_out")},
            mode="verify", caches=caches)

    def arch_features(self) -> Tuple[str, ...]:
        """See :func:`arch_features`."""
        return arch_features(self.cfg)

    def has_recurrent_state(self) -> bool:
        """True when the cache carries recurrent (non-positional) state:
        mamba's conv tail and ssm state, rwkv's token-shift rows and wkv
        state. The serving side caches must not be reused across admissions
        for such a stack (stale state is not masked out the way stale KV
        rows are)."""
        feats = arch_features(self.cfg)
        return "mamba" in feats or "rwkv" in feats


def build_model(cfg) -> LM:
    return LM(cfg=cfg)
