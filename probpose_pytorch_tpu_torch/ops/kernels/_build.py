"""Build csrc/*.cu into one plain-C shared library and load it with ctypes.

nvcc compiles every source of the package's csrc/ directory for Hopper
(sm_90a), one process per source, all started together, and links them
into `build/torch_kernels/<hash>/libprobpose_kernels.so` at the root of the
checkout. The hash covers the sources and the flags, so a library is
built once per source state and reused by every later process. The sources
include no PyTorch header: the kernels take raw pointers and a stream, which
keeps a build to seconds.

Nothing here runs at import time; `library()` builds on first use.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "build_report", "CSRC_DIR", "BUILD_ROOT"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_report: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found on PATH or under /usr/local/cuda/bin; the CUDA "
        "kernels of probpose_pytorch_tpu_torch need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    srcs = sorted(CSRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _digest() -> str:
    """Hash of the flags and of every .cu/.cuh source (headers included)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; their stderr, or raise for a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        logs.append(err)
        if proc.returncode != 0:
            for p in procs:
                p.kill()
                p.wait()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    return "".join(logs)


def _build(out: Path, srcs: list[Path]) -> None:
    """One nvcc per source, all started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        objs = [tmpdir / f"{s.stem}.o" for s in srcs]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        t0 = time.perf_counter()
        log = _run([[_nvcc(), *compile_flags, "-c", "-o", str(o), str(s)]
                    for s, o in zip(srcs, objs)])
        # Link under a temporary name and rename: concurrent processes never
        # load a half-written library.
        tmp = tmpdir / out.name
        link = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                "-o", str(tmp), *map(str, objs)]
        _run([link])
        seconds = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    _report.update(built=True, seconds=seconds,
                   command=f"{len(srcs)} parallel nvcc -c, then {' '.join(link)}")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use."""
    global _lib
    with _lock:
        if _lib is None:
            srcs = _sources()
            out = BUILD_ROOT / _digest() / "libprobpose_kernels.so"
            if not out.exists():
                _build(out, srcs)
            else:
                _report.setdefault("built", False)
            _report["path"] = str(out)
            log = out.with_suffix(".log")
            _report["ptxas"] = log.read_text() if log.exists() else ""
            _lib = ctypes.CDLL(str(out))
        return _lib


def build_report() -> dict:
    """What the last `library()` call did: `built`, `seconds`, `path`, and
    nvcc's `-Xptxas -v` register/shared-memory report (`ptxas`)."""
    return dict(_report)
