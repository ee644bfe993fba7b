"""Port vs reference: ``data/synthetic``. Both packages generate their
batches with numpy from the same seeds in the same draw order, so the
batches must be equal arrays (dtype and shape too)."""
import itertools

import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro_torch.data import synthetic as tsyn


def _take(gen, n):
    return list(itertools.islice(gen, n))


def _assert_equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, k
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("encdec_dim", [None, 8])
def test_synthetic_batches_equal(seed, encdec_dim):
    kw = dict(batch=3, seq=12, vocab=50, seed=seed, encdec_dim=encdec_dim)
    _assert_equal_batches(_take(tsyn.synthetic_batches(**kw), 3),
                          _take(jsyn.synthetic_batches(**kw), 3))


@pytest.mark.parametrize("seed,start", [(1, 0), (7, 100_000), (2, 5)])
def test_markov_batches_equal(seed, start):
    kw = dict(batch=4, seq=16, vocab=64, seed=seed, start=start)
    got = _take(tsyn.markov_batches(**kw), 3)
    _assert_equal_batches(got, _take(jsyn.markov_batches(**kw), 3))
    # labels are the next tokens of one stream
    for b in got:
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("start", [0, 100_000])
def test_markov_batches_equal_at_the_trained_models_shape(start):
    """The stream ``chip_smoke.py`` trains on and holds out (16 x 64 tokens,
    vocab 32 000, seed 7): its draws are made in one block, the
    reference's one ``choice`` call a token."""
    kw = dict(batch=16, seq=64, vocab=32_000, seed=7, start=start)
    _assert_equal_batches(_take(tsyn.markov_batches(**kw), 2),
                          _take(jsyn.markov_batches(**kw), 2))


@pytest.mark.parametrize("enc_ratio", [4, 3])
def test_markov_batches_with_encoder_frames_equal(enc_ratio):
    kw = dict(batch=2, seq=10, vocab=32, seed=5, encdec_dim=6,
              enc_ratio=enc_ratio)
    _assert_equal_batches(_take(tsyn.markov_batches(**kw), 2),
                          _take(jsyn.markov_batches(**kw), 2))


def test_markov_tables_equal():
    for a, b in zip(tsyn._markov_tables(40, 9), jsyn._markov_tables(40, 9)):
        np.testing.assert_array_equal(a, b)


def test_exported_from_data_package():
    from repro_torch import data
    assert data.markov_batches is tsyn.markov_batches
    assert data.synthetic_batches is tsyn.synthetic_batches
