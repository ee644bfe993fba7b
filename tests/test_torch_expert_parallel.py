"""Expert-parallel forward over 'model' (``distributed.sharding.
activate_mesh`` + ``tp_local`` on an MoE tree) against the one-rank
forward on the same weights, which ``tests/test_torch_moe.py`` holds to
the reference.

Reduced moonshot (4 experts, top-2) at widths where int4 128-groups stay
whole at 'model' 4, its weights the reference's ``init`` through
``convert.from_jax_params``. Four gloo rank processes run every case of
``torch_ep_workers.FWD_CASES`` on (data 2, model 2) and on (data 1,
model 4): fp, SQuant w8 quantized over the ranks' row slabs, int4 in the
``w_q4`` / ``w_scale`` serving form, and int4 with one scale per 128-group.
Each rank picks every token's experts as one rank does, at every MoE layer
of every forward, and its prefill, chunked-prefill and decode logits match
within ``rtol=atol=1e-5``. Each rank's banks are its experts' slices of the
whole tree, bit for bit (the pipeline's ``(E·out, in)`` codes and scale
rows, the serving form's expert dim), and the router is whole.

The 'expert_ff' fallback: 6 experts on (data 1, model 4) (``d_ff`` 512),
the same four trees on the port's ``init``, hold the same gates; each
rank's banks hold every expert's quarter of the FFN columns (``wi`` /
``wg`` rows of each expert's block, ``wdown``'s input columns with a
per-group scale's columns of the same groups). Only an expert count and
an expert FFN width 'model' divides neither of raises its named
``NotImplementedError``."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_ep_workers as W
from repro_torch.distributed.group import run_local
from repro_torch.distributed.sharding import (AbstractMesh,
                                              check_tensor_parallel)
from repro_torch.models.model import build_model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as tloop

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
TPS = (2, 4)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("ep")
    path = str(d / "params.pt")
    _, _, params = W.reference_params(W.FWD_OVER, None, path)
    ff_path = str(d / "ff_params.pt")
    ff = W.port_params(W.FF_OVER, W.FF_EXPERTS, ff_path)
    ranks = {tp: run_local(W.forward_ranks, 4, backend="gloo", device="cpu",
                           args=(tp, path, _names(tp), ff_path), timeout=600,
                           store_dir=str(d))
             for tp in TPS}
    return params, ranks, ff


def _names(tp):
    return list(W.FWD_CASES) + (list(W.FF_CASES) if tp == W.FF_TP else [])


_CASES = [(tp, n) for tp in TPS for n in _names(tp)]


@pytest.fixture(scope="module")
def one_rank(setup):
    params, _, ff = setup
    return {n: W.forward_with_routes(W.fwd_model(n), W.fwd_tree(
        n, ff if n in W.FF_CASES else params)) for n in _names(W.FF_TP)}


@pytest.mark.parametrize("tp,name", _CASES)
def test_forward_matches_one_rank(setup, one_rank, tp, name):
    want, _ = one_rank[name]
    for r in setup[1][tp]:
        got = r["logits"][name]
        assert list(got) == list(want)
        for mode, v in want.items():
            np.testing.assert_allclose(got[mode], v, **TOL,
                                       err_msg=f"rank {r['rank']} {mode}")


@pytest.mark.parametrize("tp,name", _CASES)
def test_expert_picks_match_one_rank(setup, one_rank, tp, name):
    """Every routing of every forward (2 MoE layers x 6 forwards) picks
    the one-rank forward's experts for every token, on every rank."""
    _, want = one_rank[name]
    assert len(want) == 2 * 6
    for r in setup[1][tp]:
        got = r["routes"][name]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert np.array_equal(a, b), (r["rank"], i)


@pytest.mark.parametrize("tp", TPS)
def test_banks_are_the_ranks_experts(setup, tp):
    """A rank at 'model' coordinate k holds experts [k·E/tp, (k+1)·E/tp)
    of every bank: the pipeline's ``(E·out, in)`` codes and scale rows,
    the serving form's ``(E, out, in)`` codes and ``w_scale`` by expert,
    fp banks by expert; the router whole."""
    params, ranks, _ = setup
    e = W.config(W.FWD_OVER).moe.n_experts
    per = e // tp
    for name in W.FWD_CASES:
        whole = W.fwd_tree(name, params)
        for r in ranks[tp]:
            k = r["coord"][1]
            for path, (codes, scale, shape) in r["banks"][name].items():
                node = W.bank_node(whole, path.split("/"))
                wc, ws, wshape = W._bank_parts(node)
                if path.endswith("router/w"):
                    assert np.array_equal(codes, wc) and shape == wshape
                    continue
                if isinstance(node, torch.Tensor):        # fp (E, in, out)
                    want_c = wc[k * per:(k + 1) * per]
                    want_s = None
                elif isinstance(node, dict):              # (E, out, in)
                    want_c = wc[k * per:(k + 1) * per]
                    want_s = ws[k * per:(k + 1) * per]
                else:                                     # (E·out, in)
                    rows = wc.shape[0] // e
                    want_c = wc[k * per * rows:(k + 1) * per * rows]
                    want_s = ws[k * per * rows:(k + 1) * per * rows]
                    assert shape == (wshape[0] // tp,) + wshape[1:]
                np.testing.assert_array_equal(codes, want_c)
                if want_s is not None:
                    np.testing.assert_array_equal(scale, want_s)


def test_expert_ff_banks_are_every_experts_columns(setup):
    """Under the 'expert_ff' fallback (6 experts on 'model' 4) the rank at
    'model' coordinate k holds every expert's FFN columns [k·f/4,
    (k+1)·f/4): ``wi``'s fp ``(E, d, f/4)``, the serving form's ``(E,
    f/4, d)`` codes and ``w_scale`` rows, the pipeline's ``(E·f/4, d)``
    codes and scale rows (each expert's block of rows, in expert order);
    ``wdown``'s fp ``(E, f/4, d)``, the serving form's input columns (bytes
    of int4) with its per-channel ``w_scale`` whole, the pipeline's
    ``(E·d, f/4)`` codes with a per-group scale's columns of the same
    groups; the router whole."""
    _, ranks, ff = setup
    e, f = W.FF_EXPERTS, W.FF_OVER["d_ff"]
    tp = W.FF_TP
    compared = 0
    for name in W.FF_CASES:
        whole = W.fwd_tree(name, ff)
        for r in ranks[tp]:
            k = r["coord"][1]
            for path, (codes, scale, shape) in r["banks"][name].items():
                node = W.bank_node(whole, path.split("/"))
                wc, ws, wshape = W._bank_parts(node)
                if path.endswith("router/w"):
                    assert np.array_equal(codes, wc) and shape == wshape
                    continue
                down = "/wdown/" in path
                if isinstance(node, torch.Tensor):        # fp (E, in, out)
                    c = wc.shape[1 if down else 2] // tp
                    want_c = wc[:, k * c:(k + 1) * c] if down else \
                        wc[:, :, k * c:(k + 1) * c]
                    want_s = None
                elif isinstance(node, dict):              # (E, out, in)
                    c = wc.shape[2 if down else 1] // tp
                    want_c = wc[:, :, k * c:(k + 1) * c] if down else \
                        wc[:, k * c:(k + 1) * c]
                    want_s = ws if down else ws[:, k * c:(k + 1) * c]
                elif down:                                # (E·d, f)
                    c = wc.shape[1] // tp
                    want_c = wc[:, k * c:(k + 1) * c]
                    g = ws.shape[1] // tp
                    want_s = ws if ws.shape[1] == 1 else \
                        ws[:, k * g:(k + 1) * g]
                    assert shape == (wshape[0], wshape[1] // tp)
                else:                                     # (E·f, d)
                    c = f // tp
                    want_c = wc.reshape(e, f, -1)[:, k * c:(k + 1) * c] \
                        .reshape(e * c, -1)
                    want_s = ws.reshape(e, f, -1)[:, k * c:(k + 1) * c] \
                        .reshape(e * c, -1)
                    assert shape == (wshape[0] // tp,) + wshape[1:]
                np.testing.assert_array_equal(codes, want_c)
                if want_s is not None:
                    np.testing.assert_array_equal(scale, want_s)
                compared += 1
    assert compared == 2 * len(W.FF_CASES) * tp


@pytest.mark.parametrize("tp", TPS)
def test_model_ranks_and_data_replicas_agree(setup, tp):
    """Every rank ends with the same whole logits, bit for bit."""
    ranks = setup[1][tp]
    for r in ranks[1:]:
        for name, modes in ranks[0]["logits"].items():
            for mode, v in modes.items():
                assert np.array_equal(r["logits"][name][mode], v), \
                    (r["rank"], name, mode)


@pytest.mark.parametrize("experts,tp", [(6, 4), (4, 8), (8, 16)])
def test_experts_not_divided_by_model_raise(experts, tp):
    """Where 'model' does not divide the expert count the reference falls
    back to 'expert_ff' (its expert FFN width): the check passes where
    'model' divides that width (the fallback) and raises its named
    ``NotImplementedError`` from ``check_tensor_parallel`` and
    ``make_train_step`` where it divides neither (the reference leaves
    the bank whole); a dividing 'model' axis passes either way."""
    base = W.config(dict(n_heads=16, n_kv_heads=16, d_model=256, d_ff=258))
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, n_experts=experts))
    mesh = AbstractMesh((1, tp), ("data", "model"))
    match = (f"not ported yet: {experts} experts and their FFN width 258 "
             f"on a 'model' axis of {tp}")
    with pytest.raises(NotImplementedError, match=match):
        check_tensor_parallel(cfg, mesh)
    with pytest.raises(NotImplementedError, match=match):
        tloop.make_train_step(build_model(cfg), topt.AdamWConfig(),
                              mesh=mesh)
    check_tensor_parallel(dataclasses.replace(cfg, d_ff=256), mesh)
    divides = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=2 * tp))
    check_tensor_parallel(divides, mesh)
