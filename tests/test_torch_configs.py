"""Port vs reference: the architecture registry and the assigned shapes.

Every registry entry equals the reference's ``ArchConfig`` field by field
(full and ``reduced()``), ``SHAPES`` and ``cells()`` are equal, what the
port does not serve for an architecture (as the reference does not: the
continuous scheduler for the encoder-decoder) raises its named
``NotImplementedError``, and every architecture builds and prefills."""
import dataclasses

import pytest
import torch

from repro import configs as jcfg
from repro_torch import configs as tcfg
from repro_torch.models.model import build_model
from repro_torch.serving.engine import ServeConfig, ServeEngine

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


# what an architecture is not served on, where it raises: the reference's
# encdec_x_continuous gate (an encoder-decoder model, ported, serves on the
# round scheduler only)
UNPORTED = {
    "seamless-m4t-medium": ("continuous",
                            "continuous scheduler does not support "
                            "encoder-decoder models"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_mixer_raises_its_named_error(name):
    where, msg = UNPORTED[name]
    cfg = dataclasses.replace(tcfg.get_config(name, reduced=True),
                              dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device="cpu")
    with pytest.raises(NotImplementedError, match=msg):
        ServeEngine(model, params, ServeConfig(scheduler=where),
                    device="cpu")


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "chameleon-34b",
                                  "granite-3-8b", "gemma-7b", "minitron-4b",
                                  "minicpm3-4b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b", "rwkv6-1.6b",
                                  "seamless-m4t-medium"])
def test_ported_architectures_init_and_run(name):
    """The reduced configs build, and a prefill gives finite logits of the
    expected shape (MLA and mixtral's ring, then jamba's mamba and rwkv,
    then the encoder-decoder over random frames, since they were ported;
    they raised before)."""
    cfg = dataclasses.replace(tcfg.get_config(name, reduced=True),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    caches = model.init_cache(2, 16, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 5),
                           generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tokens}
    if cfg.is_encdec:
        batch["enc_frames"] = torch.randn(
            (2, 5, cfg.d_model), generator=torch.Generator().manual_seed(2))
    logits, _ = model.prefill(params, batch, caches)
    assert logits.shape == (2, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
