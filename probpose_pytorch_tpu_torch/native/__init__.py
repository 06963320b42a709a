"""ctypes binding of the port's native data plane (dataplane.cpp, the JAX
package's native/__init__.py API): threaded JPEG decode and bilinear
crop-resize on the host, in the sampling convention of
ops/preprocess.py's "bilinear_gather".

The shared library builds with g++ at first use into
`build/torch_native/<hash>/` at the root of the checkout (the hash covers
the source and the flags). Where `jpeglib.h` and `-ljpeg` are found, the
build links libjpeg; where the header is missing, it builds the
crop-resize half alone (`-DPROBPOSE_NO_JPEG`), and `decode_crop_resize_batch`
and `jpeg_size` raise naming the missing header: no other decoder stands
in. `build_report()` says which build ran. Without g++ (or with
PROBPOSE_NO_NATIVE set) the plane is unavailable: `native_available()`
gates the callers, as in JAX.
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

import numpy as np

__all__ = [
    "native_available",
    "crop_resize_batch",
    "decode_crop_resize_batch",
    "jpeg_size",
    "build_report",
]

_DIR = Path(__file__).resolve().parent
SOURCE = _DIR / "dataplane.cpp"
BUILD_ROOT = _DIR.parents[1] / "build" / "torch_native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
NO_JPEG = "-DPROBPOSE_NO_JPEG"

_lock = threading.Lock()
_lib = None
_report: dict = {}


def _has_jpeg_header() -> bool:
    """Whether g++ finds jpeglib.h."""
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"], input="#include <cstdio>\n"
                           "#include <jpeglib.h>\n", capture_output=True, text=True, timeout=60)
    return probe.returncode == 0


def _build() -> Path | None:
    """The built library (built now unless this source state has one), or
    None where there is no g++; a failed compile raises."""
    if shutil.which("g++") is None:
        _report.update(available=False, reason="g++ not found on PATH")
        return None
    jpeg = _has_jpeg_header()
    flags = list(FLAGS) + ([] if jpeg else [NO_JPEG])
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_ROOT / h.hexdigest()[:16] / "libprobpose_dataplane.so"
    _report.update(jpeg=jpeg, path=str(out), flags=" ".join(flags))
    if not jpeg:
        _report["jpeg_missing"] = "jpeglib.h not found by g++: the crop-resize half only"
    if out.exists():
        _report.setdefault("built", False)
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmpdir = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        tmp = tmpdir / out.name
        cmd = ["g++", *flags, str(SOURCE), "-o", str(tmp)] + (["-ljpeg"] if jpeg else [])
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native data plane: g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr[-2000:]}")
        # Renamed into place: concurrent processes never load a half-written
        # library.
        os.replace(tmp, out)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    _report.update(built=True, seconds=time.perf_counter() - t0, command=" ".join(cmd))
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None or _report.get("available") is False:
            return _lib
        if os.environ.get("PROBPOSE_NO_NATIVE"):
            _report.update(available=False, reason="PROBPOSE_NO_NATIVE is set")
            return None
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32 = ctypes.c_int
        lib.crop_resize_batch_u8.argtypes = [u8p, i32, i32, i32, f32p, u8p, i32, i32, i32]
        lib.crop_resize_batch_u8.restype = i32
        lib.dataplane_has_jpeg.restype = i32
        if lib.dataplane_has_jpeg():
            lib.decode_crop_resize_batch.argtypes = [
                ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_ulong), i32,
                f32p, u8p, i32, i32, i32,
            ]
            lib.decode_crop_resize_batch.restype = i32
            lib.jpeg_size.argtypes = [u8p, ctypes.c_ulong, ctypes.POINTER(i32),
                                      ctypes.POINTER(i32)]
            lib.jpeg_size.restype = i32
        _report.update(available=True, jpeg=bool(lib.dataplane_has_jpeg()))
        _lib = lib
        return lib


def native_available() -> bool:
    """True when the data plane is built and loadable on this host (its
    crop-resize half at least; `build_report()["jpeg"]` says whether the
    JPEG half is built too)."""
    return _load() is not None


def build_report() -> dict:
    """Which build ran: `available`, `jpeg` (the JPEG half built),
    `jpeg_missing` (why not), `built` (compiled by this process), `seconds`,
    `path`, `flags`, `command`, or `reason` where there is no plane."""
    _load()
    return dict(_report)


def _require(jpeg: bool = False):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native data plane unavailable: {_report.get('reason')}")
    if jpeg and not _report.get("jpeg"):
        raise RuntimeError("native data plane built without its JPEG half: jpeglib.h (libjpeg's "
                           "header) was not found when it was built; install libjpeg's "
                           "development files to decode JPEGs natively")
    return lib


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crop_resize_batch(frames: np.ndarray, boxes: np.ndarray, out_size: tuple[int, int],
                      n_threads: int = 0) -> np.ndarray:
    """(n, Hs, Ws, 3) uint8 frames + (n, 4) xywh boxes -> (n, H, W, 3)
    crops, in the sampling convention of crop_resize "bilinear_gather"."""
    lib = _require()
    frames = np.ascontiguousarray(frames, np.uint8)
    boxes = np.ascontiguousarray(boxes, np.float32)
    n, hs, ws, c = frames.shape
    if c != 3 or boxes.shape != (n, 4):
        raise ValueError(f"crop_resize_batch: frames {frames.shape} and boxes {boxes.shape}: "
                         "want (n, H, W, 3) and (n, 4)")
    H, W = out_size
    out = np.empty((n, H, W, 3), np.uint8)
    lib.crop_resize_batch_u8(_u8ptr(frames), n, hs, ws,
                             boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             _u8ptr(out), H, W, n_threads)
    return out


def decode_crop_resize_batch(jpegs: list[bytes], boxes: np.ndarray, out_size: tuple[int, int],
                             n_threads: int = 0) -> tuple[np.ndarray, int]:
    """Decode n JPEG buffers and crop-resize each in one threaded pass.
    Returns (crops (n, H, W, 3) uint8, n_failed); a failed decode yields a
    zero crop."""
    lib = _require(jpeg=True)
    n = len(jpegs)
    boxes = np.ascontiguousarray(boxes, np.float32)
    if boxes.shape != (n, 4):
        raise ValueError(f"decode_crop_resize_batch: boxes {boxes.shape} for {n} buffers")
    H, W = out_size
    out = np.empty((n, H, W, 3), np.uint8)
    # the buffers stay alive for the duration of the call
    bufs = [np.frombuffer(b, np.uint8) for b in jpegs]
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_u8ptr(b) for b in bufs])
    sizes = (ctypes.c_ulong * n)(*[len(b) for b in jpegs])
    failed = lib.decode_crop_resize_batch(ptrs, sizes, n,
                                          boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                          _u8ptr(out), H, W, n_threads)
    return out, int(failed)


def jpeg_size(buf: bytes) -> tuple[int, int] | None:
    """(height, width) from a JPEG header, or None for a buffer that is no
    JPEG (or, as in JAX, a host with no plane)."""
    if _load() is None:
        return None
    lib = _require(jpeg=True)
    arr = np.frombuffer(buf, np.uint8)
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_size(_u8ptr(arr), len(buf), ctypes.byref(h), ctypes.byref(w)):
        return None
    return h.value, w.value
