#!/usr/bin/env python3
"""Where a checkpoint restore's time goes, part by part.

Writes a native-format checkpoint of ``--gb`` GB of int8 leaves (200 MB
each, the size of granite-3-8b's largest codes) into a temporary directory
with ``repro_torch.checkpoint.Checkpointer``, then times, one after the
other: the port's restore read (``_restore_raw(to_torch=False)``), one
raw ``readinto`` of the ``.npz`` file (one call reads at most ~2 GiB: its
rate is over what it read), ``zlib.crc32`` over a buffer of the file's
size, ``np.load`` of every member, each member's payload read straight
into a buffer with its CRC computed chunk by chunk, and (on a CUDA device) the
host-to-device copy of 1 GB from pageable and from pinned memory. Prints
one JSON object. Run from the repository root:

    python3 scripts/checkpoint_io_time.py [--gb 8]
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def _ms(t0):
    return (time.perf_counter() - t0) * 1e3


def _direct_read(path, chunk=256 << 10):
    """Every stored member's payload read straight into one buffer each,
    with its zip CRC computed chunk by chunk (the bytes still in cache)."""
    import struct
    import zipfile
    with zipfile.ZipFile(path) as zf, open(path, "rb", buffering=0) as f:
        for info in zf.infolist():
            f.seek(info.header_offset + 26)
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            f.seek(info.header_offset + 30 + name_len + extra_len)
            buf = memoryview(np.empty(info.file_size, np.uint8))
            crc, pos = 0, 0
            while pos < len(buf):
                n = f.readinto(buf[pos:pos + chunk])
                crc = zlib.crc32(buf[pos:pos + n], crc)
                pos += n
            if crc != info.CRC:
                raise zipfile.BadZipFile(f"CRC of {info.filename}")


def main():
    from repro_torch.checkpoint import Checkpointer

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gb", type=float, default=8.0)
    args = ap.parse_args()
    leaf = 200 * 2 ** 20
    n = max(1, int(args.gb * 1e9 // leaf))
    tree = {f"l{i:03d}": {"w_q": torch.arange(leaf, dtype=torch.int8)
                          .add_(i)} for i in range(n)}
    nbytes = n * leaf
    out = {"bytes": nbytes, "leaves": n}
    d = tempfile.mkdtemp(prefix="checkpoint_io_")
    try:
        out["free_bytes"] = shutil.disk_usage(d).free
        ck = Checkpointer(d, async_save=False)
        t0 = time.perf_counter()
        ck.save_serving(1, tree, quant_meta={"bits": 8, "method": "squant"})
        out["save_ms"] = _ms(t0)
        del tree
        path = os.path.join(d, "step_00000001", "shard_00000.npz")
        t0 = time.perf_counter()
        ck._restore_raw(1, to_torch=False)
        out["port_read_ms"] = _ms(t0)
        buf = bytearray(os.path.getsize(path))
        t0 = time.perf_counter()
        with open(path, "rb", buffering=0) as f:
            got = f.readinto(buf)            # one call: at most ~2 GiB
        out["raw_readinto_ms"] = _ms(t0)
        out["raw_read_bytes"] = got
        t0 = time.perf_counter()
        zlib.crc32(memoryview(buf))
        out["crc32_in_memory_ms"] = _ms(t0)
        del buf
        t0 = time.perf_counter()
        with np.load(path) as data:
            for k in data.files:
                data[k]
        out["np_load_ms"] = _ms(t0)
        t0 = time.perf_counter()
        _direct_read(path)
        out["direct_read_crc_ms"] = _ms(t0)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    for k in ("port_read_ms", "np_load_ms", "direct_read_crc_ms",
              "crc32_in_memory_ms", "save_ms"):
        out[k.replace("_ms", "_gb_per_s")] = nbytes / 1e6 / out[k]
    out["raw_readinto_gb_per_s"] = got / 1e6 / out["raw_readinto_ms"]
    if torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        host = torch.arange(2 ** 30, dtype=torch.int8)
        pinned = host.pin_memory()
        for name, src in (("pageable", host), ("pinned", pinned)):
            src.to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            src.to(dev)
            torch.cuda.synchronize()
            out[f"h2d_1gb_{name}_ms"] = _ms(t0)
        out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
