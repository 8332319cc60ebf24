"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  Libraries
go to ``build/kernels/`` at the root of the checkout, named by a hash
of the sources and flags, so a library is built once per source
version.  All missing libraries build in parallel, one ``nvcc`` per
source.  A failed build raises with the compiler's output; nothing
falls back to another implementation.

Flags: never ``--use_fast_math`` — the sign hash and the IEEE division
in the relmax kernel must match the plain versions bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    return BUILD_DIR / f"{name}-{_digest(src)}.so"


def build_all() -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns {name: seconds} for the sources it compiled; the compiler's
    report (registers, spills) is kept in ``build/kernels/<name>.log``."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for src in sorted(CSRC.glob("*.cu")):
        out = library_path(src.stem)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{src.stem}.log", "w")
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=log, stderr=subprocess.STDOUT)
        jobs[src.stem] = (proc, tmp, out, log)
    took, failed = {}, []
    for name, (proc, tmp, out, log) in jobs.items():
        rc = proc.wait()
        log.close()
        took[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)
    if failed:
        report = "\n".join(
            f"--- {n} ---\n{(BUILD_DIR / f'{n}.log').read_text()}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{report}")
    return took


def check_status(err_string, status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (``err_string`` is
    the library's ``*_error_string``)."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({err_string(status).decode()})")


def raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``,
    without building a ``torch.cuda.Stream`` object (for kernels whose
    launch costs less than that object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def on_operand_device(fn):
    """Run a CUDA wrapper with the device of its first argument (a
    tensor) current.  A launch through ``ctypes`` goes to the current
    device, which is where the kernels' per-device state (the SM count,
    the shared-memory opt-in) is read too, so an operand on a card that
    is not current would otherwise be launched on the wrong one."""
    import torch

    @functools.wraps(fn)
    def run(x, *args, **kwargs):
        if x.is_cuda and x.get_device() != torch.cuda.current_device():
            with torch.cuda.device(x.device):
                return fn(x, *args, **kwargs)
        return fn(x, *args, **kwargs)

    return run


def require_cuda_tensor(x, name: str, ndim: int, dtypes) -> None:
    """Raise unless ``x`` is a contiguous CUDA tensor of ``ndim``
    dimensions and one of ``dtypes``: what a kernel's pointer takes."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if x.dtype not in dtypes or x.dim() != ndim:
        raise TypeError(f"{name} must be a {ndim}-D tensor of "
                        f"{[str(t) for t in dtypes]}, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all()
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
