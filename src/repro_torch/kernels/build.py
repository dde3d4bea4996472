"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The build happens at first use, never at import: one ``nvcc -c`` per source,
all started together, then one link.  The library lands in ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``), named by a digest of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("decode_attention.cu", "masked_argmax.cu", "mamba_scan.cu",
           "ssd_scan.cu")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None   # wall time of this process's build
build_log: str = ""                     # nvcc/ptxas output of that build


def refuse_grad(name: str, *operands) -> None:
    """Raise if autograd would record this launch: the kernels write their
    outputs through raw pointers, which autograd does not see, and none has
    a backward, so a gradient through one would be silently wrong."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in operands):
        raise RuntimeError(
            f"{name}: an operand requires grad, and this kernel has no "
            "backward; serve detached params (tensor.detach()) or run the "
            "forward under torch.no_grad(), and train with "
            "use_pallas_kernels=False")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
                       "kernels of repro_torch are built on the machine with "
                       "the card")


def _build() -> pathlib.Path:
    global build_seconds, build_log
    srcs = [CSRC / s for s in SOURCES]
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = [BUILD_DIR / f"{s.stem}-{os.getpid()}.o" for s in srcs]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = []
    failed = []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate()
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib)
    for o in objs:
        o.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(build_log)
    return lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` with the argument and result types of the kernels' C entry
    points declared."""
    lib.repro_masked_argmax_packed.argtypes = [
        _I, _P, ctypes.c_longlong, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
        _P]
    lib.repro_masked_argmax_packed.restype = _I
    lib.repro_decode_attention.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, ctypes.c_float, _P]
    lib.repro_decode_attention.restype = _I
    lib.repro_decode_attention_smem.argtypes = [_I, _I, _I, _I]
    lib.repro_decode_attention_smem.restype = ctypes.c_longlong
    lib.repro_decode_attention_split.argtypes = [
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, ctypes.c_float, _P]
    lib.repro_decode_attention_split.restype = _I
    lib.repro_decode_attention_split_smem.argtypes = [_I, _I]
    lib.repro_decode_attention_split_smem.restype = ctypes.c_longlong
    lib.repro_masked_argmax_bytes.argtypes = [
        _I, _P, ctypes.c_longlong, _P, ctypes.c_longlong, _I, _I, _I, _I, _P,
        _P, _P, _P, _P]
    lib.repro_masked_argmax_bytes.restype = _I
    lib.repro_mamba_scan.argtypes = [_P] * 8 + [_I] * 7 + [_P]
    lib.repro_mamba_scan.restype = _I
    lib.repro_ssd_scan.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    lib.repro_ssd_scan.restype = _I
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this checkout has none."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(_build())))
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {code} ({msg})")
