"""Build-at-first-use for the CUDA kernels in ``csrc/``.

Each ``.cu`` file has a plain C interface and is compiled on its own by
``nvcc`` for ``sm_90a`` into a shared library under ``build/`` (next to the
package's project root, or ``$REPRO_TORCH_BUILD_DIR``), keyed by a hash of
its source and the compile flags, and loaded with ``ctypes``. Nothing here
runs at import time: a machine without ``nvcc`` can import every module of
the package, and only launching a kernel needs the build. A failed build
raises with the compiler's output.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("squant_flip", "dequant_matmul")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_seconds: Dict[str, float] = {}   # name -> nvcc wall time (0.0: cached)


def build_dir() -> str:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if not d:
        root = os.path.abspath(os.path.join(CSRC, "..", "..", "..", ".."))
        d = os.path.join(root, "build", "repro_torch")
    os.makedirs(d, exist_ok=True)
    return d


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                     "/usr/local/cuda/bin/nvcc"):
            if os.path.isfile(cand):
                exe = cand
                break
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are compiled at first use and need the CUDA "
                           "toolkit (looked on PATH, $CUDA_HOME and "
                           "/usr/local/cuda)")
    return exe


def _target(name: str, extra: Sequence[str]) -> tuple:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(NVCC_FLAGS + tuple(extra)).encode())
    return src, os.path.join(build_dir(), f"lib{name}_{h.hexdigest()[:16]}.so")


def _compile_cmd(name: str, extra: Sequence[str] = ()):
    src, out = _target(name, extra)
    return src, out, [_nvcc(), *NVCC_FLAGS, *extra, "-o", out + ".tmp", src]


def _finish(name: str, out: str, proc_rc: int, log: str, t0: float) -> None:
    if proc_rc != 0 or not os.path.isfile(out + ".tmp"):
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc_rc}):\n{log}")
    os.replace(out + ".tmp", out)        # atomic: never load a half-written lib
    build_seconds[name] = time.perf_counter() - t0


# per-source extra flags: the flip kernel's arithmetic must not be contracted
# into fused multiply-adds (q - w/s decides every flip)
EXTRA_FLAGS = {"squant_flip": ("-fmad=false",), "dequant_matmul": ()}


def build_all(names: Optional[Sequence[str]] = None, verbose: bool = False
              ) -> Dict[str, float]:
    """Compile every kernel source that is not built yet, all ``nvcc``
    processes started together. Returns ``{name: seconds}``."""
    names = tuple(names or SOURCES)
    with _lock:
        running = []
        for name in names:
            extra = EXTRA_FLAGS.get(name, ())
            src, out, cmd = _compile_cmd(name, extra)
            if os.path.isfile(out):
                build_seconds.setdefault(name, 0.0)
                continue
            if verbose:
                cmd = cmd[:1] + ["-Xptxas", "-v"] + cmd[1:]
            running.append((name, out, time.perf_counter(), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for name, out, t0, proc in running:
            log, _ = proc.communicate()
            if verbose and log:
                print(log)
            _finish(name, out, proc.returncode, log, t0)
    return {n: build_seconds[n] for n in names}


_same_device = contextlib.nullcontext()


def on_device(device):
    """Context in which ``device`` is the current CUDA device, for a launch.
    Switching devices costs a few microseconds of host time per call, so the
    common case — the tensor already lies on the current device — gets a
    context that does nothing."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return _same_device
    return torch.cuda.device(device)


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        _, out = _target(name, EXTRA_FLAGS.get(name, ()))
        lib = _libs.setdefault(name, ctypes.CDLL(out))
    return lib
