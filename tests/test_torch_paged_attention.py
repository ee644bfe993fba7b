"""Port vs reference: the paged decode attention (Pallas rows 4 and 5).

The same seeded numpy inputs go through the reference's oracles
(``paged_attention_ref``, ``paged_attention_quant_ref``), the reference's
Pallas kernel bodies in interpret mode, and the port's plain versions
(``paged_attention_plain``, ``paged_attention_quant_plain``) — the functions
the port's CUDA kernels are held against on the card — and through a
torch-ops transcription of the kernels' split plan and log-sum-exp merge. Also the int8 KV
quantizer ``_quant_tok``, bit for bit, and the port's paged decode through
``attention()`` against its contiguous decode."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import (paged_attention as j_paged,
                                           paged_attention_ref as j_ref)
from repro.kernels.paged_attention_quant import (
    paged_attention_quant as jq_paged,
    paged_attention_quant_ref as jq_ref)
from repro.models.attention import _quant_tok as j_quant_tok
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import (NEG_INF, check_args,
                                                 paged_attention_plain,
                                                 split_plan)
from repro_torch.kernels.paged_attention_quant import \
    paged_attention_quant_plain
from repro_torch.models.attention import _quant_tok

torch.set_num_threads(1)


def _inputs(rng, b, kv, rep, d, bs, nb_slot, nblocks, lengths):
    q = rng.normal(size=(b, kv * rep, d)).astype(np.float32)
    k = rng.normal(size=(nblocks, bs, kv, d)).astype(np.float32)
    v = rng.normal(size=(nblocks, bs, kv, d)).astype(np.float32)
    bt = rng.integers(1, nblocks, size=(b, nb_slot)).astype(np.int32)
    return q, k, v, bt, np.asarray(lengths, np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# kernel C's plain version (Pallas row 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rep", [1, 4])
def test_paged_plain_matches_reference_and_interpret(rng, rep):
    b, kv, d, bs, nb_slot, nblocks = 3, 2, 16, 4, 6, 20
    q, k, v, bt, ln = _inputs(rng, b, kv, rep, d, bs, nb_slot, nblocks,
                              [0, 7, 21])                  # mixed fills
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(j_ref(*_j(q, k, v, bt, ln), scale=scale))
    itp = np.asarray(j_paged(*_j(q, k, v, bt, ln), scale=scale,
                             use_pallas="interpret"))
    got = paged_attention_plain(*_t(q, k, v, bt, ln), scale=scale).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, itp, rtol=2e-5, atol=2e-5)
    # the dispatch takes the plain version for a CPU tensor
    via_ops = ops.paged_attention(*_t(q, k, v, bt, ln), scale=scale)
    np.testing.assert_array_equal(via_ops.numpy(), got)


def _poison_mask(bt, ln, nblocks, bs):
    """(nblocks, bs) True where no row reads the position unmasked."""
    dead = np.ones((nblocks, bs), bool)
    for r in range(bt.shape[0]):
        for j in range(bt.shape[1]):
            for o in range(bs):
                if j * bs + o <= ln[r]:
                    dead[bt[r, j], o] = False
    return dead


def test_paged_plain_poisoned_tail_exact(rng):
    """Columns past a row's length — the trash block 0 that table tails
    point at included — contribute exactly zero: poisoning them with +1e6
    cannot change the output, for the port as for the reference."""
    b, h, kv, d, bs, nb_slot, nblocks = 3, 2, 2, 8, 4, 4, 13
    q, k, v, _, _ = _inputs(rng, b, kv, h // kv, d, bs, nb_slot, nblocks,
                            [0, 0, 0])
    bt = np.arange(1, 1 + b * nb_slot, dtype=np.int32).reshape(b, nb_slot)
    ln = np.asarray([5, 2, 15], np.int32)
    bt[1, 1:] = 0                                          # tails -> trash
    dead = _poison_mask(bt, ln, nblocks, bs)[:, :, None, None]
    pk, pv = k + 1e6 * dead, v + 1e6 * dead
    base = paged_attention_plain(*_t(q, k, v, bt, ln), scale=0.35)
    out = paged_attention_plain(*_t(q, pk, pv, bt, ln), scale=0.35)
    np.testing.assert_array_equal(out.numpy(), base.numpy())
    jbase = np.asarray(j_ref(*_j(q, k, v, bt, ln), scale=0.35))
    np.testing.assert_allclose(base.numpy(), jbase, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# kernel D's plain version (Pallas row 5)
# ---------------------------------------------------------------------------

def _quant_pools(k, v):
    kq, ks = j_quant_tok(jnp.asarray(k))
    vq, vs = j_quant_tok(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


@pytest.mark.parametrize("rep", [1, 2, 4])
def test_quant_plain_matches_reference_and_interpret(rng, rep):
    b, kv, d, bs, nb_slot, nblocks = 3, 2, 16, 4, 6, 20
    q, k, v, bt, ln = _inputs(rng, b, kv, rep, d, bs, nb_slot, nblocks,
                              [0, 7, 21])
    kq, vq, ks, vs = _quant_pools(k, v)
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(jq_ref(*_j(q, kq, vq, ks, vs, bt, ln), scale=scale))
    itp = np.asarray(jq_paged(*_j(q, kq, vq, ks, vs, bt, ln), scale=scale,
                              use_pallas="interpret"))
    got = paged_attention_quant_plain(*_t(q, kq, vq, ks, vs, bt, ln),
                                      scale=scale).numpy()
    # the same op order as the reference oracle: float32 rounding only
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, itp, rtol=2e-5, atol=2e-5)
    via_ops = ops.paged_attention_quant(*_t(q, kq, vq, ks, vs, bt, ln),
                                        scale=scale)
    np.testing.assert_array_equal(via_ops.numpy(), got)


def test_quant_plain_poisoned_codes_and_scales_exact(rng):
    b, kv, d, bs, nb_slot, nblocks = 2, 1, 8, 4, 3, 8
    q, k, v, bt, _ = _inputs(rng, b, kv, 1, d, bs, nb_slot, nblocks, [0, 0])
    ln = np.asarray([2, 9], np.int32)
    kq, vq, ks, vs = _quant_pools(k, v)
    dead = _poison_mask(bt, ln, nblocks, bs)
    assert dead.any()
    pk = np.where(dead[:, :, None, None], np.int8(127), kq)
    pv = np.where(dead[:, :, None, None], np.int8(-127), vq)
    pks = np.where(dead[:, :, None], np.float32(1e6), ks)
    pvs = np.where(dead[:, :, None], np.float32(1e6), vs)
    base = paged_attention_quant_plain(*_t(q, kq, vq, ks, vs, bt, ln),
                                       scale=0.35)
    out = paged_attention_quant_plain(*_t(q, pk, pv, pks, pvs, bt, ln),
                                      scale=0.35)
    np.testing.assert_array_equal(out.numpy(), base.numpy())


def test_quant_plain_close_to_fp_plain(rng):
    """int8 pools from ``_quant_tok`` reproduce the fp paged result within
    int8 round-trip noise (the reference's 5 % of the magnitude)."""
    b, kv, rep, d, bs, nb_slot, nblocks = 2, 2, 2, 16, 4, 4, 12
    q, k, v, bt, ln = _inputs(rng, b, kv, rep, d, bs, nb_slot, nblocks,
                              [5, 15])
    kq, vq, ks, vs = _quant_pools(k, v)
    scale = 1.0 / np.sqrt(d)
    fp = paged_attention_plain(*_t(q, k, v, bt, ln), scale=scale).numpy()
    qn = paged_attention_quant_plain(*_t(q, kq, vq, ks, vs, bt, ln),
                                     scale=scale).numpy()
    assert np.abs(fp - qn).max() <= 0.05 * np.abs(fp).max()


def test_cuda_backend_refuses_cpu_tensor(rng):
    q, k, v, bt, ln = _t(*_inputs(rng, 1, 1, 1, 8, 4, 2, 4, [3]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.paged_attention(q, k, v, bt, ln, scale=1.0, backend="cuda")
    with ops.force_backend("ref"):
        out = ops.paged_attention(q, k, v, bt, ln, scale=1.0)
    assert out.shape == (1, 1, 8)


# ---------------------------------------------------------------------------
# the kernels' split plan and log-sum-exp merge, transcribed in torch ops
# ---------------------------------------------------------------------------

def _split_merge(q, k, v, bt, ln, scale, splits, p, ks=None, vs=None):
    """What ``csrc/paged_attention.cu`` computes, in torch ops: split ``s``
    attends over table entries ``[s*p, s*p + p)`` and keeps an unnormalised
    partial (acc, running max m, sum l), neutral (m = NEG_INF, l = 0,
    acc = 0) when it lies wholly past the slot's length; masked positions
    are not read (zeros) and their scores are the finite NEG_INF by a
    select; the partials are merged by log-sum-exp in ascending split
    order. ``ks``/``vs`` given: the int8 pool, scales folded in the
    reference's order."""
    b, h, d = q.shape
    _, bs, kv, _ = k.shape
    rep, nb = h // kv, bt.shape[1]
    qf = q.float().reshape(b, kv, rep, d)
    parts = []
    for s in range(splits):
        cols = torch.arange(s * p * bs, min((s + 1) * p * bs, nb * bs))
        blk, off = bt[:, cols // bs].long(), cols % bs
        valid = cols[None, :] <= ln[:, None].long()            # (b, n)
        kk = torch.where(valid[..., None, None], k[blk, off].float(), 0.0)
        vv = torch.where(valid[..., None, None], v[blk, off].float(), 0.0)
        sc = torch.einsum("bkrd,bnkd->bkrn", qf, kk) * scale
        if ks is not None:
            sc = sc * ks[blk, off].permute(0, 2, 1)[:, :, None, :]
        sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
        m = sc.amax(-1)
        e = torch.exp(sc - m[..., None])
        l = e.sum(-1)
        if vs is not None:
            e = e * vs[blk, off].permute(0, 2, 1)[:, :, None, :]
        acc = torch.einsum("bkrn,bnkd->bkrd", e, vv)
        empty = (s * p * bs > ln.long())[:, None, None]        # reads nothing
        parts.append((torch.where(empty, NEG_INF, m),
                      torch.where(empty, 0.0, l),
                      torch.where(empty[..., None], 0.0, acc)))
    mx = parts[0][0]
    for m, _, _ in parts[1:]:
        mx = torch.maximum(mx, m)
    tot = torch.zeros_like(mx)
    out = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:                                  # ascending
        w = torch.exp(m - mx)
        tot = tot + w * l
        out = out + w[..., None] * acc
    return (out / tot[..., None]).reshape(b, h, d).to(q.dtype)


def _split_case(rng, b, kv, rep, d, bs, nb, lengths, quant):
    """Seeded inputs with distinct blocks per slot and table tails past a
    slot's length at the trash block 0."""
    nblocks = b * nb + 1
    q = rng.normal(size=(b, kv * rep, d)).astype(np.float32)
    k = rng.normal(size=(nblocks, bs, kv, d)).astype(np.float32)
    v = rng.normal(size=(nblocks, bs, kv, d)).astype(np.float32)
    bt = (rng.permutation(b * nb) + 1).astype(np.int32).reshape(b, nb)
    for i, L in enumerate(lengths):
        bt[i, L // bs + 1:] = 0
    ln = np.asarray(lengths, np.int32)
    if quant:
        kq, vq, ksc, vsc = _quant_pools(k, v)
        return q, kq, vq, ksc, vsc, bt, ln
    return q, k, v, bt, ln


SPLIT_LENGTHS = [0, 3, 4, 95]          # 0, bs-1, bs, full at bs=4, nb=24


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [16, 64, 256])
@pytest.mark.parametrize("rep", [1, 3, 4])
def test_split_merge_matches_plain_and_reference(rng, rep, d, quant):
    """The wrapper's split plan (three splits of 8 blocks here; the last
    lies wholly past three of the four slots) and the ascending merge give
    the plain version's and the JAX oracle's output within 2e-5."""
    b, kv, bs, nb = 4, 2, 4, 24
    splits, p = split_plan(b, kv, nb, bs)
    assert (splits, p) == (3, 8)
    arrs = _split_case(rng, b, kv, rep, d, bs, nb, SPLIT_LENGTHS, quant)
    t = _t(*arrs)
    scale = 1.0 / np.sqrt(d)
    if quant:
        q, kq, vq, ksc, vsc, bt, ln = t
        got = _split_merge(q, kq, vq, bt, ln, scale, splits, p, ksc, vsc)
        plain = paged_attention_quant_plain(*t, scale=scale)
        ref = np.asarray(jq_ref(*_j(*arrs), scale=scale))
    else:
        got = _split_merge(*t, scale, splits, p)
        plain = paged_attention_plain(*t, scale=scale)
        ref = np.asarray(j_ref(*_j(*arrs), scale=scale))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("p", [1, 2, 5, 24])
@pytest.mark.parametrize("quant", [False, True])
def test_split_merge_any_split_size(rng, p, quant):
    """Any split size gives the same function: one block per split (most
    splits past the length), ragged last splits, and one split."""
    b, kv, rep, d, bs, nb = 4, 2, 4, 16, 4, 24
    splits = -(-nb // p)
    arrs = _split_case(rng, b, kv, rep, d, bs, nb, SPLIT_LENGTHS, quant)
    t = _t(*arrs)
    if quant:
        q, kq, vq, ksc, vsc, bt, ln = t
        got = _split_merge(q, kq, vq, bt, ln, 0.25, splits, p, ksc, vsc)
        want = paged_attention_quant_plain(*t, scale=0.25)
    else:
        got = _split_merge(*t, 0.25, splits, p)
        want = paged_attention_plain(*t, scale=0.25)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_split_merge_poisoned_tail_exact(rng, quant):
    """Poisoning every position no slot reads unmasked — the trash block,
    the tails that point at it, whole splits past a length — leaves the
    split-and-merge output bits unchanged."""
    b, kv, rep, d, bs, nb = 4, 2, 3, 16, 4, 24
    splits, p = split_plan(b, kv, nb, bs)
    arrs = list(_split_case(rng, b, kv, rep, d, bs, nb, SPLIT_LENGTHS,
                            quant))
    bt, ln = arrs[-2], arrs[-1]
    dead = _poison_mask(bt, ln, b * nb + 1, bs)
    assert dead[0].all() and dead.sum() > dead.shape[1]
    dirty = list(arrs)
    if quant:
        dirty[1] = np.where(dead[:, :, None, None], np.int8(127), arrs[1])
        dirty[2] = np.where(dead[:, :, None, None], np.int8(-127), arrs[2])
        dirty[3] = np.where(dead[:, :, None], np.float32(1e6), arrs[3])
        dirty[4] = np.where(dead[:, :, None], np.float32(1e6), arrs[4])
    else:
        dirty[1] = arrs[1] + 1e6 * dead[:, :, None, None]
        dirty[2] = np.where(dead[:, :, None, None], np.inf, arrs[2])

    def run(a):
        t = _t(*a)
        if quant:
            return _split_merge(t[0], t[1], t[2], t[5], t[6], 0.3, splits,
                                p, t[3], t[4])
        return _split_merge(*t, 0.3, splits, p)

    np.testing.assert_array_equal(run(dirty).numpy(), run(arrs).numpy())


def test_split_plan_depends_on_shapes_only():
    """The plan takes no lengths (the wrapper never reads them on the host)
    and covers the table exactly: splits * P >= nb > (splits - 1) * P."""
    import inspect
    assert "lengths" not in inspect.signature(split_plan).parameters
    for b in (1, 3, 8, 64):
        for kv in (1, 8, 16):
            for nb in (1, 4, 32, 256, 1000):
                for bs in (1, 8, 16, 32):
                    for sms in (1, 132):
                        s, p = split_plan(b, kv, nb, bs, sms)
                        assert 1 <= p <= nb and s * p >= nb > (s - 1) * p
                        # enough CTAs for the card, or splits at their
                        # least length, or a single split
                        assert (b * kv * s >= pa.CTAS_PER_SM * sms
                                or p * bs >= pa.MIN_SPLIT_POSITIONS
                                or s == 1)
    # the main path's shape on an H100: 8 splits of 4 blocks, 512 CTAs
    assert split_plan(8, 8, 32, 16, 132) == (8, 4)
    assert split_plan(1, 8, 32, 16, 132) == (16, 2)
    with pytest.raises(ValueError):
        split_plan(0, 8, 32, 16)


@pytest.mark.parametrize("d,ok", [(8, True), (12, False), (16, True),
                                  (256, True), (264, False)])
def test_check_args_head_dim(d, ok):
    """The kernels take a head_dim that is a multiple of 8 up to 256; the
    wrappers' argument check refuses any other before a launch."""
    q = torch.zeros(2, 4, d)
    pool = torch.zeros(3, 4, 2, d)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    ln = torch.zeros(2, dtype=torch.int32)
    if ok:
        shape, _ = check_args(q, pool, pool, bt, ln, (torch.float32,))
        assert shape == (2, 2, 2, d, 2, 4)
    else:
        with pytest.raises(ValueError, match="multiple of 8"):
            check_args(q, pool, pool, bt, ln, (torch.float32,))


# ---------------------------------------------------------------------------
# _quant_tok, bit for bit
# ---------------------------------------------------------------------------

EXTREME_ROWS = np.stack([
    np.zeros(8, np.float32),
    np.full(8, 1e-30, np.float32),
    np.full(8, -1e-30, np.float32),
    np.linspace(-1e30, 1e30, 8).astype(np.float32),
    np.asarray([1e30] + [0.0] * 7, np.float32),
    np.asarray([-1e-6, 1e-6] * 4, np.float32),
    np.linspace(-3.0, 3.0, 8).astype(np.float32),
    np.asarray([127.5, -63.25, 0.5, -0.5, 1.5, 2.5, 3.5, -127.5],
               np.float32),
])


@pytest.mark.parametrize("case", ["normal", "extreme", "wide"])
def test_quant_tok_bit_equal_to_reference(rng, case):
    if case == "normal":
        x = rng.normal(size=(3, 5, 2, 16)).astype(np.float32)
    elif case == "extreme":
        x = EXTREME_ROWS[None, :, None, :]
    else:
        x = (rng.normal(size=(64, 4, 128)) *
             rng.uniform(1e-3, 1e3, size=(64, 4, 1))).astype(np.float32)
    jc, js = j_quant_tok(jnp.asarray(x))
    tc, ts = _quant_tok(torch.from_numpy(x))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    codes = tc.numpy().astype(np.int32)
    assert codes.min() >= -127 and codes.max() <= 127
    assert np.isfinite(ts.numpy()).all()


# ---------------------------------------------------------------------------
# attention(): paged decode through the table == contiguous decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_attention_paged_decode_equals_contiguous(rng, quant):
    """The same prefilled rows, once in a contiguous cache and once in a
    block pool behind a scrambled block table: one decode step gives the
    same output and writes the same K/V (codes and scales under int8)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    from repro_torch.models.layers import rope

    cfg = dataclasses.replace(get_config("granite-3-8b", reduced=True),
                              dtype="float32")
    d, kvh, hd = cfg.d_model, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator().manual_seed(0)
    p = A.init_attention(gen, cfg, device="cpu")
    b, bs, max_len = 3, 4, 16
    nb = max_len // bs
    lens = [5, 0, 11]
    x0 = torch.from_numpy(rng.normal(size=(b, max_len, d)).astype(
        np.float32))
    cont = A.init_kv_cache(b, max_len, kvh, hd, torch.float32, quant,
                           device="cpu")
    pos = torch.arange(max_len)
    _, cont = A.attention(p, x0, cfg=cfg, rope=rope(pos, hd, cfg.rope_theta),
                          mode="prefill", cache=cont)
    pool = A.init_kv_cache(b * nb + 1, bs, kvh, hd, torch.float32, quant,
                           device="cpu")
    perm = torch.from_numpy(rng.permutation(b * nb) + 1).to(torch.int32)
    bt = perm.reshape(b, nb)
    for name in pool:
        for r in range(b):
            src = cont[name][r].reshape((nb, bs) + cont[name].shape[2:])
            pool[name][bt[r].long()] = src
    x1 = torch.from_numpy(rng.normal(size=(b, 1, d)).astype(np.float32))
    outs, written = [], []
    for r in range(b):       # contiguous: the whole batch at row r's clock
        one = {k: v.clone() for k, v in cont.items()}
        o, one = A.attention(p, x1, cfg=cfg,
                             rope=rope(torch.tensor([lens[r]]), hd,
                                       cfg.rope_theta),
                             mode="decode", cache=one, pos=lens[r])
        outs.append(o[r:r + 1])
        written.append({k: v[r, lens[r]] for k, v in one.items()})
    ln = torch.tensor(lens, dtype=torch.int32)
    po, pool = A.attention(p, x1, cfg=cfg,
                           rope=rope(ln[:, None], hd, cfg.rope_theta),
                           mode="decode", cache=pool, pos=ln,
                           block_tables=bt)
    torch.testing.assert_close(po, torch.cat(outs), rtol=1e-5, atol=1e-6)
    for name in pool:
        for r in range(b):
            got = pool[name][bt[r].long()].reshape(cont[name][r].shape)
            assert torch.equal(got[lens[r]], written[r][name])
