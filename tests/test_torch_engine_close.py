"""``ServeEngine.close`` lets go of the device memory the engine holds: the
KV cache and the graphs at once, the serving tree with the last reference
to the engine. The engine, its scheduler, its cache and its captured entry
points refer to each other, so without it they would wait for the cycle
collector; these tests hold the collector off (``close`` runs it itself)
and watch the tensors through weak references. CPU only, a reduced
config."""
import dataclasses
import gc
import weakref

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model
from repro_torch.serving import Request, ServeConfig, ServeEngine


def _tensors(obj):
    """The tensors an object holds, through dicts, lists, tuples and
    ``__dict__`` (each object visited once)."""
    out, seen, todo = [], set(), [obj]
    while todo:
        o = todo.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        if torch.is_tensor(o):
            out.append(o)
        elif isinstance(o, dict):
            todo.extend(o.values())
        elif isinstance(o, (list, tuple)):
            todo.extend(o)
        elif hasattr(o, "__dict__") and not isinstance(o, type) \
                and type(o).__module__.startswith("repro_torch"):
            todo.extend(vars(o).values())
    return out


@pytest.fixture(scope="module")
def model_params():
    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              dtype="float32")
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(scheduler="round"),
    dict(scheduler="continuous", kv_backend="contiguous"),
    dict(scheduler="continuous", kv_backend="paged", block_size=16,
         prefill_chunk=8),
    dict(scheduler="continuous", kv_backend="paged", block_size=16,
         speculative=True, draft_k=2, draft_bits=4),
], ids=["round", "contiguous", "paged", "speculative"])
def test_close_frees_the_engines_tensors_without_the_collector(model_params,
                                                               kw):
    model, params = model_params
    eng = ServeEngine(model, params, ServeConfig(
        quantize_weights="squant", weight_bits=8, **kw), device="cpu")
    eng.generate([Request(list(range(1, 21)), 4, request_id=0),
                  Request(list(range(5, 14)), 3, request_id=1)])
    # the leaves the serving tree shares with the fp tree stay the caller's
    theirs = {id(t) for t in _tensors(params)}
    held = [t for t in _tensors(eng.store) + _tensors(eng.scheduler)
            if id(t) not in theirs]
    assert len(held) > 10
    refs = [weakref.ref(t) for t in held]
    del held
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng.close()
        eng.close()                              # idempotent
        assert not eng.store.stats()["watching"]
        del eng
        alive = sum(r() is not None for r in refs)
    finally:
        if collecting:
            gc.enable()
    assert alive == 0
