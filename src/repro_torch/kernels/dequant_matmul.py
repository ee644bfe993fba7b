"""Quantized-weight matmul ``y = x @ dequant(Wq).T``: wrapper, launch counter,
plain version.

The CUDA source is ``csrc/dequant_matmul.cu``: six hand-written variants,
one of which :func:`variant` picks per launch by one rule on shapes, types
and alignment; see the note at the source's head. ``Wq`` holds int8 codes
``(M, N)``, or (every ``bits <= 4``) nibbles packed two-per-byte
``(M, N/2)``, low nibble = even column, with ``(M, 1)`` per-channel or
``(M, N/G)`` per-group float32 scales.

The decode variant ``tcgemv`` (``B <= GEMV_MAX_BATCH``) splits K over CTAs
by :func:`split_plan`, the prefill variant ``mma`` (more rows) by
:func:`prefill_plan`; both depend on shapes, the SM count and the kernel's
occupancy only, and add the splits' float32 partials in ascending split
order. Each has a bfloat16 instance and a float32 one (``tcgemv32``,
``mma32``): float32 x goes to the tensor cores exactly, split into three
bf16 parts (:func:`split_bf16x3`) whose three passes accumulate in float32.
``gemv`` and ``tiled`` (CUDA cores) take what those cannot: misaligned x or
codes, ragged N, other group sizes. :func:`dequant_matmul_tc_order` and
:func:`dequant_matmul_mma_order` transcribe the orders of summation in
torch ops for the CPU tests; nothing on a CUDA tensor calls them or
:func:`split_bf16x3`.

Dispatch rule: a CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises. There is no fallback from the kernel to the plain
version.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.quant.qtypes import unpack_int4

GEMV_MAX_BATCH = 16      # up to here the small-batch variants run
                         # (SMALL_BATCH_MAX in the .cu file)
VARIANTS = ("gemv", "tcgemv", "mma", "tiled", "tcgemv32", "mma32")
                         # ids of the .cu's variants, in its enum's order
TC_ROWS = 128            # output rows per CTA of tcgemv (TC_ROWS in the .cu)
TC_CTAS_PER_SM = 2       # tcgemv's split plan fills this many CTAs per SM
                         # (at most the instance's occupancy)

PF_ROWS = 128            # output rows per CTA of mma (PF_BN in the .cu)
PF_M_TILE = 64           # tokens per m-tile of mma (PF_BM in the .cu)
PF_MT1_MAX_B = 64        # up to here one m-tile per mma CTA, above two
                         # (per-channel bfloat16; PF_MT1_MAX_B in the .cu;
                         # mma32 always takes one)
PF_UNIT = 128            # columns of an mma split unit (PF_UNIT in the .cu)
PF_CTAS_PER_SM = 2       # mma's plan fills this many CTAs per SM (at most
                         # the instance's occupancy)

launches = 0             # number of kernel launches (plain integer)
launches_by_variant = {v: 0 for v in VARIANTS}   # the same, by variant
launches_by_shape = {}   # the same, by "<variant> <M>x<N>" (weight shape)


def shape_key(v: str, m: int, n: int) -> str:
    """``launches_by_shape``'s key of a ``v`` launch on an (M, N) weight."""
    return f"{v} {m}x{n}"


def dequant_matmul_plain(x: torch.Tensor, codes: torch.Tensor,
                         scale: torch.Tensor, *, bits: int,
                         group_size: int = 128) -> torch.Tensor:
    """Plain PyTorch version: dequantize, then one float32 matmul."""
    m = codes.shape[0]
    c = unpack_int4(codes) if bits <= 4 else codes
    c = c.to(torch.float32)
    n = c.shape[1]
    ng = n // group_size
    s = scale.to(torch.float32).reshape(m, -1).expand(m, ng)
    w = (c.reshape(m, ng, group_size) * s[..., None]).reshape(m, n)
    return (x.to(torch.float32) @ w.T).to(x.dtype)


def tc_krange(bits: int) -> int:
    """Columns of one tcgemv k-range: a lane holds 16 code bytes of a row,
    16 int8 codes or 32 nibbles, and four lanes share a row."""
    return 128 if bits <= 4 else 64


def tc_column_order(bits: int) -> torch.Tensor:
    """The order in which tcgemv's k16 steps take the columns of one
    k-range: entry ``16*j + s`` is the column (relative to the k-range)
    behind k-slot ``s`` of step ``j``. Lane ``tig`` of a row quad holds
    columns ``tig*KR/4 ..`` of the row; slots ``2*tig, 2*tig+1`` (fragment
    registers a0/b0) and ``2*tig+8, 2*tig+9`` (a2/b1) are its. int8: step j
    takes columns 4j, 4j+1 and 4j+2, 4j+3 of the lane's 16; int4: the nibble
    pairs (8i+p, 8i+p+4) that one mask of a code word gives, i = j // 2,
    p = 2*(j % 2) for a0 and p + 1 for a2."""
    kr = tc_krange(bits)
    order = []
    for j in range(kr // 16):
        for s in range(16):
            tig, e, half = (s & 7) >> 1, s & 1, s >> 3
            if bits <= 4:
                p = 2 * (j & 1) + half
                col = tig * 32 + 8 * (j >> 1) + p + 4 * e
            else:
                col = tig * 16 + 4 * j + 2 * half + e
            order.append(col)
    return torch.tensor(order, dtype=torch.int64)


def split_bf16x3(x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """float32 ``x`` as three bfloat16 tensors, ``hi = bf16(x)``, ``mid =
    bf16(x - hi)``, ``lo = bf16(x - hi - mid)`` (round to nearest even, as
    the kernels' ``split_bf16x3``), with ``hi + mid + lo == x`` exactly in
    float32 for finite ``|x|`` in ``[2**-110, 2**127 * (2 - 2**-8))`` and
    for zeros: each remainder is exact in float32 and holds at most 16,
    then 8, significant bits. For the CPU tests; nothing on a CUDA tensor
    calls it."""
    if x.dtype != torch.float32:
        raise ValueError(f"split_bf16x3 takes float32, got {x.dtype}")
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _dot(xf: torch.Tensor, c: torch.Tensor, cols, bf16x3: bool
         ) -> torch.Tensor:
    """``xf[:, cols] @ c[:, cols].T`` in float32 (``cols`` a slice or an
    index tensor); ``bf16x3``: x split by :func:`split_bf16x3` and, at each
    k16 step of ``cols`` (16 columns at a time, in their order), the hi,
    mid and lo passes added in that order into one accumulator, as the
    float32 instances issue them."""
    if not bf16x3:
        return xf[:, cols] @ c[:, cols].T
    if isinstance(cols, slice):
        cols = torch.arange(cols.start, cols.stop)
    parts = [p.float() for p in split_bf16x3(xf)]
    acc = torch.zeros((xf.shape[0], c.shape[0]), dtype=torch.float32)
    for k in range(0, cols.numel(), 16):
        step = cols[k:k + 16]
        for p in parts:
            acc = acc + p[:, step] @ c[:, step].T
    return acc


def variant(b: int, n: int, group_size: int, scols: int, bits: int,
            bf16: bool, x_ptr: int, codes_ptr: int) -> str:
    """Which variant of ``csrc/dequant_matmul.cu`` takes a launch: the one
    rule, on shapes, types and alignment. Up to ``GEMV_MAX_BATCH`` rows,
    16-byte aligned x and codes and a group size that is a whole number of
    k-ranges take ``tcgemv`` (bfloat16 x) or ``tcgemv32`` (float32 x),
    else ``gemv``. Larger batches with 16-byte aligned x and codes, N a
    multiple of 128 and per-channel scales or 128-column groups take
    ``mma`` (bfloat16) or ``mma32`` (float32), else ``tiled``."""
    aligned = x_ptr % 16 == 0 and codes_ptr % 16 == 0
    if b <= GEMV_MAX_BATCH:
        if aligned and group_size % tc_krange(bits) == 0:
            return "tcgemv" if bf16 else "tcgemv32"
        return "gemv"
    if aligned and n % 128 == 0 and (scols == 1 or group_size == 128):
        return "mma" if bf16 else "mma32"
    return "tiled"


def split_plan(m: int, n: int, group_size: int, sms: int = 132,
               ctas_per_sm: int = TC_CTAS_PER_SM) -> Tuple[int, int]:
    """``(splits, groups_per_split)`` of a tcgemv launch: ``M`` output rows
    in tiles of ``TC_ROWS``, ``N / group_size`` scale groups, on a card of
    ``sms`` SMs at ``ctas_per_sm`` CTAs each. Split ``s`` takes groups
    ``[s*P, s*P + P)``; ``splits * P >= groups > (splits - 1) * P``. The
    plan takes the most splits whose CTAs (row tiles times splits) fit one
    wave of ``sms * ctas_per_sm``: a CTA past the wave would double its
    SM's share of the work. It depends on shapes only, never on values: the
    launch needs no host sync and is the same every decode step."""
    if min(m, n, group_size, sms, ctas_per_sm) < 1 or n % group_size:
        raise ValueError(f"split_plan needs positive shapes and N a multiple "
                         f"of the group size, got m={m} n={n} "
                         f"group_size={group_size} sms={sms} "
                         f"ctas_per_sm={ctas_per_sm}")
    ng = n // group_size
    row_ctas = -(-m // TC_ROWS)
    want = max(1, sms * ctas_per_sm // row_ctas)
    p = -(-ng // min(want, ng))
    return -(-ng // p), p


def prefill_tile_rows(b: int, per_group: bool, f32: bool = False) -> int:
    """Tokens per CTA of the ``mma`` variant: one 64-row m-tile up to
    ``PF_MT1_MAX_B`` rows, with per-group scales (whose group partials
    need a second set of accumulators) or for float32 x (``mma32``, whose
    x stage is twice as large), else two."""
    return PF_M_TILE if per_group or f32 or b <= PF_MT1_MAX_B \
        else 2 * PF_M_TILE


def prefill_plan(b: int, m: int, n: int, group_size: Optional[int],
                 sms: int = 132, ctas_per_sm: int = PF_CTAS_PER_SM,
                 f32: bool = False) -> Tuple[int, int]:
    """``(splits, units_per_split)`` of an ``mma`` (``f32``: ``mma32``)
    launch: ``M`` output rows in tiles of ``PF_ROWS``, ``B`` tokens in
    tiles of :func:`prefill_tile_rows`, ``N / PF_UNIT`` column units (a unit is a
    scale group when ``group_size`` is given; ``None`` means per-channel
    scales), on a card of ``sms`` SMs at ``ctas_per_sm`` CTAs each. Split
    ``s`` takes units ``[s*P, s*P + P)``; ``splits * P >= units > (splits -
    1) * P``. The plan takes the most splits whose CTAs (output tiles times
    splits) fit one wave, but no more than ``N / (2B)`` (their float32
    partials, ``4 * B * M`` bytes a split, stay under the ``M * N`` code
    bytes; ``f32``: ``N / B``, partials as wide as the float32 x the
    instance reads anyway, which lets seamless's cross K/V at 512 rows
    split in two: 0.0188 -> 0.0142 ms, ``scripts/dequant_matmul_sweep.py
    --float32``) and none of fewer than two units. It depends on shapes
    only, never on values."""
    if min(b, m, n, sms, ctas_per_sm) < 1 or n % PF_UNIT or \
            group_size not in (None, PF_UNIT):
        raise ValueError(f"prefill_plan needs positive shapes, N a multiple "
                         f"of {PF_UNIT} and per-channel scales or groups of "
                         f"{PF_UNIT}, got b={b} m={m} n={n} "
                         f"group_size={group_size} sms={sms} "
                         f"ctas_per_sm={ctas_per_sm}")
    units = n // PF_UNIT
    tiles = -(-m // PF_ROWS) * -(-b // prefill_tile_rows(
        b, group_size is not None, f32))
    cap = n // b if f32 else n // (2 * b)
    most = max(1, min(sms * ctas_per_sm // tiles, cap, units // 2))
    p = -(-units // most)
    return -(-units // p), p


def dequant_matmul_mma_order(x: torch.Tensor, codes: torch.Tensor,
                             scale: torch.Tensor, *, bits: int,
                             splits: int, ups: int,
                             bf16x3: bool = False) -> torch.Tensor:
    """The ``mma`` variant's order of summation in torch ops (for the CPU
    tests). Split ``s`` takes the ``PF_UNIT``-column units ``[s*ups,
    s*ups + ups)``. Per-channel scales (one column): the split's float32
    dot product over all its columns, times the row's scale once. Per-group
    scales (groups of ``PF_UNIT``): each group's float32 dot product times
    the group's scale, added to the split's sum in ascending group order.
    Then the splits' sums added in ascending split order, and one rounding
    to x's dtype. ``bf16x3`` (``mma32``, float32 x): each dot product is
    the three passes of :func:`_dot`, k16 step by step."""
    m = codes.shape[0]
    c = (unpack_int4(codes) if bits <= 4 else codes).to(torch.float32)
    n = c.shape[1]
    units = n // PF_UNIT
    if n % PF_UNIT or splits * ups < units or (splits - 1) * ups >= units:
        raise ValueError(f"{splits} splits of {ups} units do not cover "
                         f"{units} units of {PF_UNIT} columns")
    s = scale.to(torch.float32).reshape(m, -1)
    if s.shape[1] not in (1, units):
        raise ValueError(f"scale has {s.shape[1]} columns; the mma variant "
                         f"takes 1 or {units}")
    if bf16x3 and x.dtype != torch.float32:
        raise ValueError("the three-pass order takes float32 x")
    xf = x.to(torch.float32)
    total = None
    for sp in range(splits):
        lo, hi = sp * ups, min(units, sp * ups + ups)
        if s.shape[1] == 1:
            cols = slice(lo * PF_UNIT, hi * PF_UNIT)
            acc = _dot(xf, c, cols, bf16x3) * s[:, 0]
        else:
            acc = None
            for g in range(lo, hi):
                cols = slice(g * PF_UNIT, (g + 1) * PF_UNIT)
                part = _dot(xf, c, cols, bf16x3) * s[:, g]
                acc = part if acc is None else acc + part
        total = acc if total is None else total + acc
    return total.to(x.dtype)


def dequant_matmul_tc_order(x: torch.Tensor, codes: torch.Tensor,
                            scale: torch.Tensor, *, bits: int,
                            group_size: int, splits: int, gps: int,
                            bf16x3: bool = False) -> torch.Tensor:
    """tcgemv's order of summation in torch ops (for the CPU tests): within
    a split, each scale group's float32 dot product over its columns in
    :func:`tc_column_order`, times the group's scale, added to the split's
    sum in ascending group order; then the splits' sums added in ascending
    split order, and one rounding to x's dtype. ``bf16x3`` (``tcgemv32``,
    float32 x): each group's dot product is the three passes of
    :func:`_dot` at each k16 step of that column order."""
    m = codes.shape[0]
    c = (unpack_int4(codes) if bits <= 4 else codes).to(torch.float32)
    n = c.shape[1]
    ng = n // group_size
    if splits * gps < ng or (splits - 1) * gps >= ng:
        raise ValueError(f"{splits} splits of {gps} groups do not cover "
                         f"{ng} groups")
    kr = tc_krange(bits)
    if group_size % kr:
        raise ValueError(f"group size {group_size} is not a whole number "
                         f"of {kr}-column k-ranges")
    if bf16x3 and x.dtype != torch.float32:
        raise ValueError("the three-pass order takes float32 x")
    s = scale.to(torch.float32).reshape(m, -1).expand(m, ng)
    order = tc_column_order(bits)
    in_group = (torch.arange(group_size // kr)[:, None] * kr
                + order[None, :]).reshape(-1)
    xf = x.to(torch.float32)
    total = None
    for sp in range(splits):
        acc = torch.zeros((x.shape[0], m), dtype=torch.float32)
        for g in range(sp * gps, min(ng, sp * gps + gps)):
            cols = g * group_size + in_group
            acc = acc + _dot(xf, c, cols, bf16x3) * s[:, g]
        total = acc if total is None else total + acc
    return total.to(x.dtype)


_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("dequant_matmul").dequant_matmul_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        _fn = fn
    return _fn


_occ: Dict[tuple, Tuple[int, int]] = {}


def _card_occupancy(key: tuple, query: str, args: Tuple[int, ...],
                    device: int) -> Tuple[int, int]:
    """``(SMs, CTAs per SM)`` of a kernel instance on CUDA device
    ``device``: the occupancy query ``query`` of the ``.cu`` asked once per
    ``key``."""
    if key not in _occ:
        fn = getattr(_build.load("dequant_matmul"), query)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p]
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = fn(*args, ctypes.addressof(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"{query} failed (cuda error {err}, "
                               f"{out.value} CTAs per SM)")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _occ[key] = (sms, out.value)
    return _occ[key]


def card_ctas_per_sm(bits: int, b: int, device: int,
                     f32: bool = False) -> Tuple[int, int]:
    """``(SMs, CTAs per SM)`` of tcgemv's instance for ``bits``, batch
    ``b`` and float32 x (``f32``) on CUDA device ``device``."""
    packed = bits <= 4
    return _card_occupancy(("tcgemv", packed, 1 if b <= 8 else 2, f32,
                            device), "dequant_matmul_tc_ctas_per_sm",
                           (int(packed), b, int(f32)), device)


def card_pf_ctas_per_sm(bits: int, b: int, scols: int, device: int,
                        f32: bool = False) -> Tuple[int, int]:
    """``(SMs, CTAs per SM)`` of the ``mma`` instance for ``bits``, ``b``
    rows, ``scols`` scale columns and float32 x (``f32``) on CUDA device
    ``device``."""
    packed = bits <= 4
    return _card_occupancy(
        ("mma", packed, prefill_tile_rows(b, scols != 1, f32), scols != 1,
         f32, device), "dequant_matmul_pf_ctas_per_sm",
        (int(packed), b, scols, int(f32)), device)


_plans: Dict[tuple, Tuple[str, int, int]] = {}


def launch_plan(x: torch.Tensor, codes: torch.Tensor, m: int,
                scols: int, group_size: int, bits: int
                ) -> Tuple[str, int, int]:
    """``(variant, splits, groups_per_split)`` of a launch on x's card,
    cached per shape, type and alignment. For ``mma`` and ``mma32`` the
    third entry counts ``PF_UNIT``-column units."""
    b, n = x.shape
    bf16 = x.dtype == torch.bfloat16
    xp, cp = x.data_ptr(), codes.data_ptr()
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    key = (b, m, n, scols, group_size, bits, bf16, xp % 16, cp % 16, dev)
    plan = _plans.get(key)
    if plan is None:
        v = variant(b, n, group_size, scols, bits, bf16, xp, cp)
        splits, gps = 1, n // group_size
        if v in ("tcgemv", "tcgemv32"):
            sms, occ = card_ctas_per_sm(bits, b, dev, not bf16)
            splits, gps = split_plan(m, n, group_size, sms,
                                     min(occ, TC_CTAS_PER_SM))
        elif v in ("mma", "mma32"):
            sms, occ = card_pf_ctas_per_sm(bits, b, scols, dev, not bf16)
            splits, gps = prefill_plan(b, m, n, None if scols == 1
                                       else group_size, sms,
                                       min(occ, PF_CTAS_PER_SM), not bf16)
        plan = _plans[key] = (v, splits, gps)
    return plan


def cached_plans(variant_: Optional[str] = None) -> list:
    """The plans :func:`launch_plan` has made so far (of ``variant_`` only,
    if given), one dict per launch shape with its key's fields (rows,
    weight shape, scale columns, group, bits, activation dtype, the
    pointers' offsets from 16-byte alignment): for reports, and to launch
    the kernel again at the shapes a path made."""
    return [{"b": k[0], "m": k[1], "n": k[2], "scols": k[3],
             "group_size": k[4], "bits": k[5],
             "dtype": "bfloat16" if k[6] else "float32",
             "x_align": k[7], "codes_align": k[8],
             "variant": v, "splits": sp, "per_split": p}
            for k, (v, sp, p) in sorted(_plans.items())
            if variant_ in (None, v)]


def dequant_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   *, bits: int, group_size: int = 128,
                   plan: Optional[Tuple[str, int, int]] = None
                   ) -> torch.Tensor:
    """y[B, M] = x[B, N] @ (codes[M, N] * scale).T, float32 accumulation,
    output in ``x.dtype`` (float32 or bfloat16). ``plan`` is a
    ``(variant, splits, groups_per_split)`` to launch instead of
    :func:`launch_plan`'s, for timing another variant or split; the kernel
    refuses one that cannot take the shape."""
    b, n = x.shape
    packed = bits <= 4
    m = codes.shape[0]
    n_codes = codes.shape[1] * (2 if packed else 1)
    if n_codes != n:
        raise ValueError(f"x has N={n} but codes unpack to {n_codes}")
    if n % group_size != 0:
        raise ValueError(f"N={n} not divisible by group_size={group_size}")
    ng = n // group_size
    scale = scale.reshape(m, -1)
    if scale.shape[1] not in (1, ng):
        raise ValueError(f"scale has {scale.shape[1]} columns; expected 1 or "
                         f"{ng}")
    if not x.is_cuda:
        return dequant_matmul_plain(x, codes, scale, bits=bits,
                                    group_size=group_size)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if codes.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("codes must be int8 and scale float32")
    if codes.device != x.device or scale.device != x.device:
        raise ValueError("x, codes and scale must be on the same device")
    # is_contiguous() is a cheap check; contiguous() is a dispatched op
    if not x.is_contiguous():
        x = x.contiguous()
    if not codes.is_contiguous():
        codes = codes.contiguous()
    if not scale.is_contiguous():
        scale = scale.contiguous()
    out = torch.empty((b, m), dtype=x.dtype, device=x.device)
    if b == 0 or m == 0:
        return out
    global launches
    v, splits, gps = plan or launch_plan(x, codes, m, scale.shape[1],
                                         group_size, bits)
    part = torch.empty((splits, b, m), dtype=torch.float32,
                       device=x.device) if splits > 1 else None
    with _build.on_device(x.device):
        err = _kernel()(x.data_ptr(), codes.data_ptr(), scale.data_ptr(),
                        out.data_ptr(), None if part is None
                        else part.data_ptr(), b, m, n, scale.shape[1],
                        group_size, int(packed),
                        int(x.dtype == torch.bfloat16), VARIANTS.index(v),
                        splits, gps, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul kernel launch failed ({v}, "
                           f"cuda error {err})")
    launches += 1
    launches_by_variant[v] += 1
    key = shape_key(v, m, n)
    launches_by_shape[key] = launches_by_shape.get(key, 0) + 1
    return out
