"""Variants of the port's kernel library for the timing tools in this
directory: an older kernel source built on its own (a baseline, timed
beside the current kernel in the same run), and the whole library built
again with a kernel's source edited: one part taken out (an ablation: what
a part costs is how much faster the kernel runs without it) or a layout or
schedule changed (a variant).  Both land in the git-ignored
``build/kernels/``.  Also the timing helpers the tools share: a pair of
readings taken in turns, and the SM clock and power draw sampled while a
kernel runs.  The callers put the repository's ``src`` on ``sys.path``
first.
"""
from __future__ import annotations

import contextlib
import ctypes
import pathlib
import subprocess
import time

OUT = pathlib.Path(__file__).resolve().parents[1] / "build" / "kernels"


def _nvcc_flags(build):
    """The library's nvcc flags without ptxas's register report."""
    return [build._nvcc(),
            *(f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v"))]


def baseline(path, entry, argtypes):
    """The C entry point ``entry`` of the older kernel source ``path``,
    built on its own, with ``argtypes`` declared and an int result."""
    from repro_torch.kernels import build
    so = OUT / f"baseline_{entry}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([*_nvcc_flags(build), "-shared", "-o", str(so), str(path)],
                   check=True)
    fn = getattr(ctypes.CDLL(str(so)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def edited(source, edits):
    """{name: the kernel library built with ``csrc/<source>`` edited by
    that name's (text, replacement) pairs}, all built together.  Each text
    must occur once in the source."""
    from repro_torch.kernels import build
    out = OUT / f"edited_{pathlib.Path(source).stem}"
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / source).read_text()
    others = [str(build.CSRC / n) for n in build.SOURCES if n != source]
    procs = {}
    for name, reps in edits.items():
        text = src
        for old, new in reps:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {source} no longer "
                                   f"holds {old.strip()!r} once")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [*_nvcc_flags(build), "-shared", "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu"), *others])
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"{name}: nvcc failed")
    return {name: build.bind(ctypes.CDLL(str(out / f"{name}.so")))
            for name in edits}


@contextlib.contextmanager
def launching_from(lib):
    """Inside the block the kernels' wrappers launch from ``lib``."""
    from repro_torch.kernels import build
    saved = build.library()
    build._lib = lib
    try:
        yield
    finally:
        build._lib = saved


def pair(time_ms, other, kernel, n):
    """([other, other], [kernel, kernel]) ms by ``time_ms(fn, n)``, timed
    in the order other, kernel, kernel, other."""
    t = [time_ms(f, n) for f in (other, kernel, kernel, other)]
    return [t[0], t[3]], t[1:3]


def clock_during(torch, fn, seconds=1.0):
    """Median SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    while ``fn`` runs back to back for about ``seconds``."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out, _ = smi.communicate()
    rows = [list(map(float, line.split(","))) for line in out.splitlines()
            if line.strip()]
    if not rows:
        return None, None
    mid = sorted(rows)[len(rows) // 2]
    return mid[0], mid[1]
