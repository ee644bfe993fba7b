"""Port vs reference: the architecture registry and the assigned shapes.

Every registry entry equals the reference's ``ArchConfig`` field by field
(full and ``reduced()``), ``SHAPES`` and ``cells()`` are equal, and an
architecture whose sequence mixer is not ported raises its named
``NotImplementedError("not ported yet: …")``."""
import dataclasses

import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.models.model import build_model

ARCHS = jcfg.list_archs()


def _fields(cfg):
    """Field name -> value, nested configs as plain dicts."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = dataclasses.asdict(v) if dataclasses.is_dataclass(v) \
            else v
    return out


def test_registry_lists_the_reference_architectures():
    assert tcfg.list_archs() == ARCHS
    assert len(ARCHS) == 10


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_config_equals_reference(name, reduced):
    a = jcfg.get_config(name, reduced=reduced)
    b = tcfg.get_config(name, reduced=reduced)
    assert _fields(b) == _fields(a)
    for sub in ("moe", "mla", "mamba"):
        va, vb = getattr(a, sub), getattr(b, sub)
        assert (va is None) == (vb is None)
        if va is not None:
            assert type(vb).__name__ == type(va).__name__


def test_shapes_and_cells_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()}
    cfgs_t = [tcfg.get_config(n) for n in ARCHS]
    cfgs_j = [jcfg.get_config(n) for n in ARCHS]
    assert tcfg.cells(cfgs_t) == jcfg.cells(cfgs_j)


# the unported mixer of each architecture, where it raises
UNPORTED = {
    "minicpm3-4b": ("init", "not ported yet: MLA attention"),
    "jamba-1.5-large-398b": ("init", "not ported yet: block kind 'm'"),
    "rwkv6-1.6b": ("init", "not ported yet: block kind 'rwkv'"),
    "seamless-m4t-medium": ("init",
                            "not ported yet: encoder-decoder models"),
    "mixtral-8x7b": ("cache", "not ported yet: sliding-window ring cache"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_mixer_raises_its_named_error(name):
    where, msg = UNPORTED[name]
    cfg = dataclasses.replace(tcfg.get_config(name, reduced=True),
                              dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match=msg):
        if where == "init":
            model.init(gen, device="cpu")
        else:
            model.init(gen, device="cpu")
            model.init_cache(1, 16, device="cpu")


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "chameleon-34b",
                                  "granite-3-8b", "gemma-7b", "minitron-4b"])
def test_ported_architectures_init_and_run(name):
    """The reduced configs whose mixers are ported build, and a prefill
    gives finite logits of the expected shape."""
    cfg = dataclasses.replace(tcfg.get_config(name, reduced=True),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    caches = model.init_cache(2, 16, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(1))
    logits, _ = model.prefill(params, {"tokens": tokens}, caches)
    assert logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
