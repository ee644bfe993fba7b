"""MoE routing under data parallelism: the port's data-parallel step routes
the tokens the reference routes together.

The reference's jitted step is GSPMD, so it routes the global batch: one
capacity from the global token count, positions by one cumulative sum in
global token order, the load-balancing loss over global means; its
pod-compressed step routes each pod's batch (``shard_map`` over 'pod').
Four gloo rank processes (``distributed.group.run_local``) run the port's
step on reduced moonshot (4 experts, top-2) at ``capacity_factor`` 1.0,
where capacity binds (each expert's buffer holds the mean load, half the
tokens; the experts above it drop tokens), on (data 2), (data 2) with
``microbatches=2``, (data 4) with 2 microbatches, (pod 2, data 2), and
(pod 2, data 2) with ``pod_compress``. Each is held to the reference's ``_accumulate_grads``
on the global batch in one process (each pod's batch for the compressed
step, its metrics averaged over the pods): loss and ``moe_aux`` within
1e-5 relative, the averaged gradients within ``GRAD_TOL``
(``tests/test_torch_train_step.py``'s). Without a routing group
``moe_ffn`` is bit-identical to its form before routing groups
(transcribed here)."""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_ep_workers as W
from repro_torch import convert
from repro_torch.distributed.group import run_local
from repro_torch.distributed.sharding import RoutingGroup, activate_routing
from repro_torch.models import moe as moe_lib

torch.set_num_threads(1)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
REL = 1e-5


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_dp")
    path = str(d / "params.pt")
    jmodel, jparams, _ = W.reference_params(W.ROUTE_OVER, W.BINDING_CF,
                                            path)
    batch = W.batch_of(256)[0]
    ref = {}
    for name, (shape, axes, mb, compress) in W.ROUTE_CASES.items():
        pods = shape[0] if compress else 1
        per = batch["tokens"].shape[0] // pods
        rows = [W.jax_accumulated(jmodel, jparams,
                                  {k: v[p * per:(p + 1) * per]
                                   for k, v in batch.items()}, mb)
                for p in range(pods)]
        loss = float(np.mean([r[0] for r in rows]))
        met = {k: float(np.mean([r[1][k] for r in rows]))
               for k in ("xent", "moe_aux")}
        grads = None if compress else {
            k: v.numpy() for k, v in W.TPW._leaves(
                convert.from_jax_params(rows[0][2], device="cpu"))}
        ref[name] = (loss, met, grads)
    ranks = run_local(W.routing_ranks, 4, backend="gloo", device="cpu",
                      args=(path, batch, list(W.ROUTE_CASES)), timeout=600,
                      store_dir=str(d))
    return ref, ranks, (jmodel, jparams, batch)


@pytest.mark.parametrize("name", list(W.ROUTE_CASES))
def test_step_routes_like_the_reference(both, name):
    """Every rank the case's mesh covers reports the reference's loss,
    ``xent`` and ``moe_aux``, and (a plain step) its gradients."""
    ref, ranks, _ = both
    loss, met, grads = ref[name]
    seen = 0
    for r in ranks:
        got = r["cases"].get(name)
        if got is None:
            continue
        seen += 1
        np.testing.assert_allclose(got["loss"], loss, rtol=REL, atol=0)
        for k in ("xent", "moe_aux"):
            np.testing.assert_allclose(got[k], met[k], rtol=REL, atol=0,
                                       err_msg=k)
        assert got["routing_calls"] > 0
        if grads is not None:
            assert sorted(got["grads"]) == sorted(grads)
            for k, g in grads.items():
                np.testing.assert_allclose(got["grads"][k], g, **GRAD_TOL,
                                           err_msg=f"rank {r['rank']} {k}")
    assert seen == int(np.prod(W.ROUTE_CASES[name][0]))


def test_capacity_binds(both):
    """The setting is one where routing each rank's tokens alone gives
    another result: the per-rank mean of ``moe_aux`` (what the step
    reported before routing groups) is not the global batch's."""
    ref, _, (jmodel, jparams, batch) = both
    halves = [W.jax_accumulated(jmodel, jparams,
                                {k: v[h * 4:(h + 1) * 4]
                                 for k, v in batch.items()}, 1)[1]["moe_aux"]
              for h in range(2)]
    assert abs(np.mean(halves) - ref["data2"][1]["moe_aux"]) > \
        100 * REL * ref["data2"][1]["moe_aux"]


def _moe_ffn_before(params, x, *, n_experts, top_k, kind="swiglu",
                    capacity_factor=1.25, dropless=False):
    """``moe_ffn`` as it was before routing groups and expert
    parallelism (no token blocking: the cases here are small)."""
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = moe_lib.route(params["router"], xt, top_k)
    if dropless:
        capacity = t
    else:
        capacity = max(1, math.ceil(t * top_k * capacity_factor / n_experts))
        capacity = min(capacity, t)
    onehot = moe_lib._one_hot(gate_idx, n_experts, torch.int32)
    flatoh = onehot.reshape(t * top_k, n_experts)
    pos = torch.cumsum(flatoh, dim=0) * flatoh - 1
    pos = pos.reshape(t, top_k, n_experts)
    within = (pos * onehot).sum(-1)
    keep = (within < capacity) & (within >= 0)
    dt = x.dtype
    disp = torch.zeros((t, n_experts, capacity), dtype=dt)
    comb = torch.zeros((t, n_experts, capacity), dtype=dt)
    for kk in range(top_k):
        oh_e = moe_lib._one_hot(gate_idx[:, kk], n_experts, dt)
        oh_c = moe_lib._one_hot(torch.where(keep[:, kk], within[:, kk],
                                            capacity), capacity + 1,
                                dt)[..., :-1]
        d_k = oh_e[:, :, None] * oh_c[:, None, :] \
            * keep[:, kk, None, None].to(dt)
        disp = disp + d_k
        comb = comb + d_k * gate_vals[:, kk, None, None].to(dt)
    ein = torch.einsum("tec,td->ecd", disp, xt).contiguous()
    gate = moe_lib.expert_matmul(params["wg"], ein)
    gate = F.silu(gate) if kind == "swiglu" else \
        F.gelu(gate, approximate="tanh")
    h = gate * moe_lib.expert_matmul(params["wi"], ein)
    out = moe_lib.expert_matmul(params["wdown"], h)
    y = torch.einsum("tec,ecd->td", comb, out).reshape(b, s, d)
    density = (disp.sum(-1) > 0).to(torch.float32).mean(0)
    aux = n_experts * torch.sum(density * probs.mean(0))
    return y, aux


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf,dropless", [(0.5, False), (1.25, False),
                                         (1.25, True)])
def test_no_routing_group_is_bit_identical(dtype, cf, dropless):
    """Without a routing group (and under one of a single rank) the
    output, the aux loss and their gradients are bit for bit those of the
    form before routing groups."""
    g = torch.Generator().manual_seed(0)
    params = moe_lib.init_moe(g, 64, 96, 8, "swiglu", device="cpu")
    x = torch.randn((3, 10, 64), generator=g).to(dtype)
    kw = dict(n_experts=8, top_k=2, capacity_factor=cf, dropless=dropless)

    def run(fn, group=None):
        p = {k: {kk: vv.detach().clone().requires_grad_(True)
                 for kk, vv in v.items()} for k, v in params.items()}
        xi = x.detach().clone().requires_grad_(True)
        with activate_routing(group):
            y, aux = fn(p, xi, **kw)
        (y.float().square().sum() + aux).backward()
        return [y, aux, xi.grad] + [p[k]["w"].grad for k in sorted(p)]

    want = run(_moe_ffn_before)
    for group in (None, RoutingGroup((), (), 0)):
        for a, b in zip(run(moe_lib.moe_ffn, group), want):
            assert torch.equal(a, b)
