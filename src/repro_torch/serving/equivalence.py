"""Tolerance-equivalence harness: teacher-forced greedy-token agreement.

Some serving configurations break bit-identity by construction — int8 KV
codes perturb every attention read; on the GPU, the paged-attention kernel's
online softmax and the dequant-matmul kernel's two summation orders (weight
streaming for a few rows, tensor cores above) round differently from the
contiguous path — so they are held to a *measured agreement budget* instead
of token identity.

The metric is **teacher-forced greedy-token agreement**: run the oracle
engine once to get its greedy continuation per request, then run the
configuration under test with the continuous scheduler's ``token_override``
hook forcing the oracle's token into each slot after sampling. Every step
therefore asks "given the oracle's exact context, does this configuration's
argmax match?" — per-step conditional agreement, with no divergence
compounding. The rate is ``matched / compared`` over all requests and
positions.

Budgets are keyed per feature (``int8_kv`` for the serve config; the
architecture keys of :func:`repro_torch.models.model.arch_features`) and
compose multiplicatively when features stack. The table is the reference
package's own.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["AGREEMENT_BUDGETS", "AgreementReport", "active_budget_keys",
           "agreement_budget", "greedy_token_agreement", "oracle_tokens"]

# Hard floors on teacher-forced greedy agreement vs the fp oracle, keyed by
# the feature that breaks bit-identity. A config with no active key owes
# exact tokens (budget 1.0).
AGREEMENT_BUDGETS: Dict[str, float] = {
    "int8_kv": 0.98,
    "exact": 1.0,
    # architecture keys, active while chunk-continuation prefill is in play
    # (prefill_chunk > 0, or the paged backend's shared-prefix suffix
    # continuation)
    "mla": 1.0,
    "sliding_window": 0.95,
    "moe": 0.85,
    "mamba": 0.95,
    "rwkv": 0.95,
}


def active_budget_keys(cfg, arch_cfg=None) -> List[str]:
    """The ``AGREEMENT_BUDGETS`` keys a (ServeConfig, architecture) pair
    activates. Architecture keys apply only when chunk-continuation prefill
    can run (``prefill_chunk > 0`` or the paged backend)."""
    keys: List[str] = []
    if cfg.quantize_kv:
        keys.append("int8_kv")
    if arch_cfg is not None and (cfg.prefill_chunk > 0
                                 or cfg.kv_backend == "paged"):
        from repro_torch.models.model import arch_features
        keys.extend(arch_features(arch_cfg))
    return keys


def agreement_budget(cfg, arch_cfg=None) -> float:
    """The agreement floor a (ServeConfig, architecture) pair owes vs the fp
    oracle: the product of every active feature floor (1.0 when none)."""
    budget = 1.0
    for key in active_budget_keys(cfg, arch_cfg):
        budget *= AGREEMENT_BUDGETS[key]
    return budget


@dataclasses.dataclass
class AgreementReport:
    matched: int
    compared: int
    per_request: Dict[int, Tuple[int, int]]   # rid -> (matched, compared)
    # (rid, position) of every compared token that differed from the oracle's
    mismatches: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    @property
    def rate(self) -> float:
        return 1.0 if self.compared == 0 else self.matched / self.compared

    def assert_budget(self, budget: float, label: str = "") -> None:
        if self.rate < budget:
            worst = sorted(self.per_request.items(),
                           key=lambda kv: kv[1][0] / max(kv[1][1], 1))[:3]
            raise AssertionError(
                f"greedy-token agreement {self.rate:.4f} < budget "
                f"{budget:.2f}{' (' + label + ')' if label else ''}; "
                f"worst requests {worst} "
                f"({self.matched}/{self.compared} matched)")


def oracle_tokens(completions) -> Dict[int, List[int]]:
    """Completion list → {request_id: greedy tokens} (the oracle side)."""
    return {c.request_id: [int(t) for t in c.tokens] for c in completions}


def greedy_token_agreement(engine, requests: Sequence,
                           oracle: Dict[int, List[int]]
                           ) -> AgreementReport:
    """Teacher-forced agreement of ``engine`` (continuous scheduler) vs an
    oracle's greedy tokens.

    Installs the scheduler's ``token_override`` hook for one
    ``generate(requests)`` call: at every sampling step the engine's
    proposed token is compared against — then replaced by — the oracle's
    token at that position, so the engine's KV cache always holds the
    oracle's continuation. Requests absent from ``oracle`` (or positions
    past its tokens) run free and are not counted.
    """
    sch = engine.scheduler
    if not hasattr(sch, "token_override"):
        raise ValueError(
            "greedy_token_agreement requires the continuous scheduler "
            "(the round scheduler has no token_override hook)")
    matched = 0
    compared = 0
    per: Dict[int, Tuple[int, int]] = {}
    missed: List[Tuple[int, int]] = []

    def override(rid: int, t: int, proposed: int) -> Optional[int]:
        nonlocal matched, compared
        toks = oracle.get(rid)
        if toks is None or t >= len(toks):
            return None
        hit = int(proposed == toks[t])
        m, n = per.get(rid, (0, 0))
        per[rid] = (m + hit, n + 1)
        matched += hit
        compared += 1
        if not hit:
            missed.append((rid, t))
        return int(toks[t])

    prev = sch.token_override
    sch.token_override = override
    try:
        engine.generate(list(requests))
    finally:
        sch.token_override = prev
    return AgreementReport(matched, compared, per, missed)
