"""The port's native ingest library: ctypes bindings, built at first use.

The counterpart of `caffeonspark_tpu/native/` (the reference's native
image path: jcaffe Mat -> cv::imdecode, FloatDataTransformer ->
caffe::DataTransformer), in two shared libraries that g++ builds from
the sources beside this file into `build/torch_native/` at the
repository root, each named by the hash of its sources and flags (a
later process of the same checkout loads an earlier one's build):

  * `cos_bytes.cpp`, the byte moves: `crop_mirror_u8` (the host half of
    the device-side transform, under `Transformer.host_stage`) and
    `transform_batch` (Caffe's transform on a float batch); no library
    beyond the C++ runtime;
  * `cos_jpeg.cpp`, the threaded libjpeg decoders: `decode_batch` to
    float32 or uint8 BGR planes, linked with `-ljpeg`.

COS_NATIVE=0 (the JAX package's knob and default) selects the numpy and
cv2 paths instead.  Otherwise a failed build raises: nothing falls back
quietly.  The one exception is a machine without libjpeg (no
`jpeglib.h` or no `-ljpeg`): it keeps the byte moves, `decode_available`
is False there, and `decode_batch` raises naming libjpeg.

Nothing builds at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXXFLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
# library -> (source, extra link flags)
LIBRARIES = {"cos_bytes": ("cos_bytes.cpp", []),
             "cos_jpeg": ("cos_jpeg.cpp", ["-ljpeg"])}
HEADERS = ("cos_parallel.h",)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_missing_jpeg: Optional[str] = None     # why libjpeg is unusable, once seen


class LibjpegMissing(RuntimeError):
    """The machine has no libjpeg to build the decoders against."""


def enabled() -> bool:
    """False under COS_NATIVE=0 (read at each call, never at import)."""
    return os.environ.get("COS_NATIVE", "").lower() not in ("0", "false",
                                                            "no")


def _target(name: str) -> Path:
    src, link = LIBRARIES[name]
    h = hashlib.sha256()
    for f in (src, *HEADERS):
        h.update((SRC_DIR / f).read_bytes())
    h.update(" ".join(CXXFLAGS + link).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _jpeg_missing(text: str) -> bool:
    return "jpeglib.h" in text or "-ljpeg" in text


def build(names: Sequence[str] = tuple(LIBRARIES)) -> dict:
    """Compile each named library that has no up-to-date build, one g++
    process per library, started together.  Returns `libraries`
    {name: path}, `built` (the names compiled now), `seconds`,
    `libjpeg` (False when the decoders could not be built for want of
    libjpeg; they are then left out) and `output` {name: g++ output}.
    Any other failure raises."""
    global _missing_jpeg
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = {n: p for n, p in targets.items() if not p.exists()}
    t0 = time.monotonic()
    procs = {}
    for name, out in todo.items():
        src, link = LIBRARIES[name]
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = ["g++", *CXXFLAGS, str(SRC_DIR / src), "-o", str(tmp), *link]
        try:
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        except OSError as e:
            raise RuntimeError(f"native library {name}: cannot run g++ "
                               f"({e}); set COS_NATIVE=0 for the numpy "
                               "path") from e
    output: Dict[str, str] = {}
    errors = []
    libjpeg = True
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate(timeout=300)
        output[name] = text
        if proc.returncode == 0:
            os.replace(tmp, out)
        elif name == "cos_jpeg" and _jpeg_missing(text):
            libjpeg = False
            _missing_jpeg = text.strip().splitlines()[0] if text.strip() \
                else "g++ -ljpeg failed"
            targets.pop(name)
        else:
            errors.append(f"g++ {LIBRARIES[name][0]} failed "
                          f"({proc.returncode}):\n{text}")
    if errors:
        raise RuntimeError("\n".join(errors))
    return {"libraries": targets, "built": sorted(todo),
            "seconds": time.monotonic() - t0, "libjpeg": libjpeg,
            "output": output}


def _load(name: str) -> ctypes.CDLL:
    """The loaded library, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if name == "cos_jpeg" and _missing_jpeg is not None:
            raise LibjpegMissing(_missing_jpeg)
        paths = build((name,))["libraries"]
        if name not in paths:
            raise LibjpegMissing(_missing_jpeg)
        try:
            handle = ctypes.CDLL(str(paths[name]))
        except OSError:
            # a build copied from another machine whose libraries this
            # one lacks (libjpeg.so): build it here, once
            paths[name].unlink()
            paths = build((name,))["libraries"]
            if name not in paths:
                raise LibjpegMissing(_missing_jpeg) from None
            handle = ctypes.CDLL(str(paths[name]))
        lib = _declare(name, handle)
        _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if name == "cos_bytes":
        lib.cos_transform_batch.restype = None
        lib.cos_transform_batch.argtypes = [P, I, I, I, I, I, P, P, P, P, I,
                                            F, P, I]
        lib.cos_crop_mirror_u8.restype = None
        lib.cos_crop_mirror_u8.argtypes = [P, I, I, I, I, I, P, P, P, P, I]
        lib.cos_native_version.restype = I
    else:
        for fn in (lib.cos_decode_batch, lib.cos_decode_batch_u8):
            fn.restype = I
            fn.argtypes = [ctypes.c_char_p, P, P, I, I, I, I, P, I]
    return lib


def available() -> bool:
    """The byte moves: False under COS_NATIVE=0, else True once the
    library loads (a build failure raises)."""
    if not enabled():
        return False
    _load("cos_bytes")
    return True


def decode_available() -> bool:
    """The decoders: False under COS_NATIVE=0 or without libjpeg, else
    True once the library loads (any other build failure raises)."""
    if not enabled():
        return False
    try:
        _load("cos_jpeg")
    except LibjpegMissing:
        return False
    return True


def version() -> int:
    return _load("cos_bytes").cos_native_version()


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _per_image(n: int, h: int, w: int, crop: int, h_off, w_off, mirror):
    """The per-image crop origins and mirror flags as contiguous int32 /
    uint8 arrays of length n, checked to keep every read inside the
    (h, w) input."""
    zeros = np.zeros(n, np.int32)
    ho = np.ascontiguousarray(zeros if h_off is None else h_off, np.int32)
    wo = np.ascontiguousarray(zeros if w_off is None else w_off, np.int32)
    mi = np.ascontiguousarray(np.zeros(n, np.uint8) if mirror is None
                              else mirror, np.uint8)
    if not (ho.shape == wo.shape == mi.shape == (n,)):
        raise ValueError(f"need {n} crop offsets and mirror flags, got "
                         f"{ho.shape}, {wo.shape}, {mi.shape}")
    if crop and (crop > h or crop > w or (n and (
            ho.min() < 0 or wo.min() < 0 or ho.max() > h - crop
            or wo.max() > w - crop))):
        raise ValueError(f"crop {crop} at the given offsets leaves the "
                         f"{h}x{w} input")
    return ho, wo, mi


def decode_batch(images: Sequence[bytes], *, channels: int, out_h: int,
                 out_w: int, num_threads: int = 0,
                 out_dtype=np.float32) -> np.ndarray:
    """JPEG bytes -> (N, C, out_h, out_w) BGR planes, float32 (default)
    or uint8 (the device-side transform's feed: its truncating store
    equals `float_output.astype(uint8)`).  `num_threads` 0 means one
    thread per core.  Raises ValueError when an image fails to decode,
    LibjpegMissing (naming libjpeg) on a machine without it."""
    try:
        lib = _load("cos_jpeg")
    except LibjpegMissing as e:
        raise LibjpegMissing(
            f"decoding encoded images needs libjpeg (jpeglib.h and "
            f"-ljpeg) for the native decoder, and this machine has none: "
            f"{e}") from e
    n = len(images)
    if channels not in (1, 3) or out_h < 1 or out_w < 1:
        raise ValueError(f"decode to {channels} channels of {out_h}x{out_w}:"
                         " need 1 or 3 channels and a positive size")
    blob = b"".join(images)
    sizes = np.asarray([len(b) for b in images], np.int64)
    offsets = np.zeros(n, np.int64)
    if n > 1:
        np.cumsum(sizes[:-1], out=offsets[1:])
    u8 = np.dtype(out_dtype) == np.uint8
    out = np.empty((n, channels, out_h, out_w),
                   np.uint8 if u8 else np.float32)
    fn = lib.cos_decode_batch_u8 if u8 else lib.cos_decode_batch
    ok = fn(blob, _ptr(offsets), _ptr(sizes), n, channels, out_h, out_w,
            _ptr(out), int(num_threads))
    if ok != n:
        raise ValueError(f"{n - ok}/{n} images failed to decode")
    return out


def transform_batch(batch: np.ndarray, *, crop: int = 0,
                    h_off: Optional[np.ndarray] = None,
                    w_off: Optional[np.ndarray] = None,
                    mirror: Optional[np.ndarray] = None,
                    mean: Optional[np.ndarray] = None,
                    scale: float = 1.0,
                    num_threads: int = 0) -> np.ndarray:
    """Caffe's transform on an (N, C, H, W) float32 batch: crop at the
    per-image offsets, mirror, subtract the mean (per channel, or a
    (C, crop, crop) plane), scale."""
    lib = _load("cos_bytes")
    batch = np.ascontiguousarray(batch, np.float32)
    n, c, h, w = batch.shape
    oh, ow = (crop, crop) if crop else (h, w)
    ho, wo, mi = _per_image(n, h, w, crop, h_off, w_off, mirror)
    out = np.empty((n, c, oh, ow), np.float32)
    mean_ptr, mode = None, 0
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        if mean.ndim == 1:
            if mean.shape != (c,):
                raise ValueError(f"{len(mean)} mean values for {c} "
                                 "channels")
            mode = 1
        else:
            if mean.shape != (c, oh, ow):
                raise ValueError(f"mean plane {mean.shape} != {(c, oh, ow)}")
            mode = 2
        mean_ptr = _ptr(mean)
    lib.cos_transform_batch(_ptr(batch), n, c, h, w, int(crop), _ptr(ho),
                            _ptr(wo), _ptr(mi), mean_ptr, mode,
                            float(scale), _ptr(out), int(num_threads))
    return out


def crop_mirror_u8(batch: np.ndarray, h_off: np.ndarray,
                   w_off: np.ndarray, mirror: np.ndarray, *,
                   crop: int = 0, num_threads: int = 0) -> np.ndarray:
    """Threaded uint8 crop (+ mirror) of an (N, C, H, W) batch at the
    per-image offsets (ignored when crop is 0): only bytes move, the
    random draws stay with the caller."""
    lib = _load("cos_bytes")
    batch = np.ascontiguousarray(batch, np.uint8)
    n, c, h, w = batch.shape
    oh, ow = (crop, crop) if crop else (h, w)
    ho, wo, mi = _per_image(n, h, w, crop, h_off, w_off, mirror)
    out = np.empty((n, c, oh, ow), np.uint8)
    lib.cos_crop_mirror_u8(_ptr(batch), n, c, h, w, int(crop), _ptr(ho),
                           _ptr(wo), _ptr(mi), _ptr(out), int(num_threads))
    return out
