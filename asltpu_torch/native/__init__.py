"""ctypes binding of the port's native decode libraries. Counterpart of
``asltpu/native/__init__.py``, with the same C ABI, version stamp and
error contract (``-1`` → cannot open, ``-2`` → no decodable frames, each
raised as ``IOError``).

Two libraries, each one C++ source of this directory:

- ``decode.cpp`` (``lib="opencv"``): OpenCV's C++ API, byte-identical to
  the Python cv2 path of :mod:`asltpu_torch.data.decode`;
- ``decode_av.cpp`` (``lib="av"``): libavcodec directly; staging resamples
  the decoder's own YUV planes, and ``FAST_*`` flags trade exactness for
  decode work. Close to the cv2 path, not byte-identical.

Each is built at first use with ``g++ -O3 -fPIC -shared -std=c++17`` into
``asltpu_torch/_build/<name>-<hash>.so`` through the build cache of
:mod:`asltpu_torch._buildcache` (the hash covers the sources and the flags;
a temporary file renamed into place, so concurrent processes never open a
half-written library). A whole batch decodes on native threads in one call,
during which ctypes releases the interpreter lock.

A library is unavailable when its toolchain is missing (``g++``, or the
OpenCV 4 / libav headers): :func:`toolchain_missing` names what is missing.
A build that fails with the toolchain present is unavailable too, with the
compiler's log named in the reason. After a failed build the environment
flag ``ASLTPU_TORCH_NATIVE_DISABLE`` (``ASLTPU_TORCH_NATIVE_AV_DISABLE``
for av) is set, so spawned decode workers do not repeat it; set it to skip
the build altogether. An already-built library still loads.

numpy and the standard library only: spawned decode workers import this.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from asltpu_torch import _buildcache

_DIR = Path(__file__).resolve().parent
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
_INT_MIN = -(2 ** 31)
ABI_VERSION = 1

# Fast-mode bit flags of the libav backend (decode_av.cpp enum).
FAST_LOWRES = 1        # DCT-domain reduced-resolution decode (mpeg4 family)
FAST_SKIP_LOOP_FILTER = 2  # h264/hevc deblocking off
FAST_SKIP_NONREF = 4   # drop non-reference (B) frames when unsampled
# What ``decode_fast=True`` means everywhere (stream_predict, the bench).
FAST_ALL = FAST_LOWRES | FAST_SKIP_LOOP_FILTER | FAST_SKIP_NONREF

_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_u8_p = ctypes.POINTER(ctypes.c_uint8)
_c_char_pp = ctypes.POINTER(ctypes.c_char_p)
_I = ctypes.c_int


@dataclasses.dataclass(frozen=True)
class _Spec:
    """One native library: its source, the SDK header that marks its
    toolchain, where to look for it, what to link, and its C functions as
    ``name: (restype, argtypes)``."""

    name: str
    source: str
    header: str
    include_dirs: Tuple[str, ...]
    libs: Tuple[str, ...]
    disable_env: str
    abi_symbol: str
    functions: Dict[str, Tuple[object, Tuple[object, ...]]]


OPENCV = _Spec(
    name="decode", source="decode.cpp", header="opencv2/videoio.hpp",
    include_dirs=("/usr/include/opencv4",),
    libs=("-lopencv_core", "-lopencv_videoio", "-lopencv_imgproc"),
    disable_env="ASLTPU_TORCH_NATIVE_DISABLE",
    abi_symbol="asltpu_native_abi_version",
    functions={
        "asltpu_decode_clip": (_I, (ctypes.c_char_p, _I, _I, _I, _I, _I, _I,
                                    _c_int_p, _I, _c_u8_p)),
        "asltpu_decode_batch": (_I, (_c_char_pp, _I, _I, _I, _I, _I, _c_int_p,
                                     _c_int_p, _c_int_p, _I, _I, _c_u8_p,
                                     _c_int_p)),
        "asltpu_native_abi_version": (_I, ()),
    },
)
AV = _Spec(
    name="decode_av", source="decode_av.cpp", header="libavcodec/avcodec.h",
    include_dirs=("/usr/include/x86_64-linux-gnu", "/usr/include"),
    libs=("-lavformat", "-lavcodec", "-lavutil", "-lswscale"),
    disable_env="ASLTPU_TORCH_NATIVE_AV_DISABLE",
    abi_symbol="asltpu_av_abi_version",
    functions={
        "asltpu_av_decode_clip": (_I, (ctypes.c_char_p, _I, _I, _I, _I, _I, _I,
                                       _c_int_p, _I, _I, _c_u8_p)),
        "asltpu_av_decode_batch": (_I, (_c_char_pp, _I, _I, _I, _I, _I, _c_int_p,
                                        _c_int_p, _c_int_p, _I, _I, _I, _c_u8_p,
                                        _c_int_p)),
        "asltpu_av_encode_synthetic": (_I, (ctypes.c_char_p, _I, _I, _I, _I, _I,
                                            _I)),
        "asltpu_av_abi_version": (_I, ()),
    },
)
SPECS = {"opencv": OPENCV, "av": AV}


def _compiler() -> Optional[str]:
    return shutil.which("g++")


def _include_dir(spec: _Spec) -> Optional[str]:
    for d in spec.include_dirs:
        if os.path.isfile(os.path.join(d, spec.header)):
            return d
    return None


def toolchain_missing(lib: str = "opencv") -> Optional[str]:
    """What ``lib`` ("opencv" or "av") lacks to be built here, naming the
    compiler or the header path looked for; None when all is present."""
    spec = SPECS[lib]
    if _compiler() is None:
        return "g++ not found on PATH"
    if _include_dir(spec) is None:
        looked = ", ".join(os.path.join(d, spec.header) for d in spec.include_dirs)
        return f"header not found: {looked}"
    return None


def _cflags(spec: _Spec, include_dir: str) -> List[str]:
    return [*CXX_FLAGS, f"-I{include_dir}"]


def library_path(lib: str = "opencv") -> Path:
    """Where ``lib`` is built: the hash covers its source, the shared
    header, the compile flags and the libraries it links."""
    spec = SPECS[lib]
    return _buildcache.output_path(
        spec.name, [_DIR / spec.source, _DIR / "decode_common.h"],
        [*_cflags(spec, _include_dir(spec) or ""), *spec.libs])


def build(lib: str = "opencv") -> Path:
    """Compile ``lib`` unless it is built; raise ``RuntimeError`` naming the
    missing toolchain or the compiler's log."""
    spec = SPECS[lib]
    out = library_path(lib)
    if out.exists():
        return out
    missing = toolchain_missing(lib)
    if missing:
        raise RuntimeError(f"cannot build {spec.source}: {missing}")
    cflags = _cflags(spec, _include_dir(spec))
    _buildcache.build([(out, lambda tmp: [
        _compiler(), *cflags, str(_DIR / spec.source), *spec.libs, "-o", str(tmp)])],
        "g++", timeout=600)
    return out


class _Library:
    """One library, loaded once per process: the ``CDLL`` or the reason it
    is unavailable."""

    def __init__(self, key: str):
        self.key = key
        self.spec = SPECS[key]
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._err: Optional[str] = None

    def load(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and self._err is None:
                self._lib, self._err = self._open()
            return self._lib

    def reason(self) -> Optional[str]:
        self.load()
        return self._err

    def require(self) -> ctypes.CDLL:
        lib = self.load()
        if lib is None:
            raise RuntimeError(f"native {self.spec.name} unavailable: {self._err}")
        return lib

    def _open(self) -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
        spec = self.spec
        path = library_path(self.key)
        if not path.exists():
            if os.environ.get(spec.disable_env):
                return None, f"native build disabled ({spec.disable_env} is set)"
            try:
                build(self.key)
            except (RuntimeError, OSError) as e:
                # Inherited by spawned decode workers: they skip the build.
                os.environ[spec.disable_env] = "1"
                return None, str(e)
        try:
            lib = ctypes.CDLL(str(path))
            for fn, (restype, argtypes) in spec.functions.items():
                f = getattr(lib, fn)
                f.restype, f.argtypes = restype, list(argtypes)
        except (OSError, AttributeError) as e:
            return None, f"cannot load {path}: {e}"
        version = getattr(lib, spec.abi_symbol)()
        if version != ABI_VERSION:
            return None, f"{path}: ABI version {version}, expected {ABI_VERSION}"
        return lib, None


_LIBS = {key: _Library(key) for key in SPECS}


def available() -> bool:
    return _LIBS["opencv"].load() is not None


def unavailable_reason() -> Optional[str]:
    return _LIBS["opencv"].reason()


def av_available() -> bool:
    return _LIBS["av"].load() is not None


def av_unavailable_reason() -> Optional[str]:
    return _LIBS["av"].reason()


def _frame_shape(hs: int, ws: int, yuv420: bool) -> Tuple[int, ...]:
    return (hs * 3 // 2, ws) if yuv420 else (hs, ws, 3)


def _check_clip_rc(rc: int, path: str) -> None:
    if rc == -1:
        raise IOError(f"cannot open video: {path}")
    if rc != 0:
        raise IOError(f"no decodable frames in {path}")


def _bbox(bbox) -> Optional[ctypes.Array]:
    return (ctypes.c_int * 4)(*[int(v) for v in bbox]) if bbox else None


def _out(n: Optional[int], num_frames: int, staging_size, yuv420: bool):
    lead = () if n is None else (n,)
    return np.empty((*lead, num_frames, *_frame_shape(*staging_size, yuv420)),
                    np.uint8)


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_c_u8_p)


def _i32(a: np.ndarray):
    return a.ctypes.data_as(_c_int_p)


def decode_clip_native(
    path: str,
    num_frames: int,
    staging_size: Tuple[int, int],
    host_resize_short: int = 0,
    frame_start: int = 1,
    frame_end: int = -1,
    bbox=None,
    yuv420: bool = False,
) -> np.ndarray:
    """One clip on the OpenCV library; raises IOError like the cv2 path."""
    lib = _LIBS["opencv"].require()
    out = _out(None, num_frames, staging_size, yuv420)
    hs, ws = staging_size
    rc = lib.asltpu_decode_clip(path.encode(), num_frames, hs, ws, host_resize_short,
                                int(frame_start), int(frame_end), _bbox(bbox),
                                int(yuv420), _u8(out))
    _check_clip_rc(rc, path)
    return out


def decode_clip_av(
    path: str,
    num_frames: int,
    staging_size: Tuple[int, int],
    host_resize_short: int = 0,
    frame_start: int = 1,
    frame_end: int = -1,
    bbox=None,
    yuv420: bool = False,
    fast_flags: int = 0,
) -> np.ndarray:
    """One clip on the libav library. ``fast_flags``: OR of ``FAST_*``."""
    lib = _LIBS["av"].require()
    out = _out(None, num_frames, staging_size, yuv420)
    hs, ws = staging_size
    rc = lib.asltpu_av_decode_clip(path.encode(), num_frames, hs, ws,
                                   host_resize_short, int(frame_start),
                                   int(frame_end), _bbox(bbox), int(yuv420),
                                   int(fast_flags), _u8(out))
    _check_clip_rc(rc, path)
    return out


def _batch_args(items: Sequence):
    """Paths, segment starts and ends, and boxes (INT_MIN: none) of paths
    or clip records (anything with ``path`` and ``frame_start``)."""
    paths, fs, fe, bbs = [], [], [], []
    for it in items:
        if hasattr(it, "path") and hasattr(it, "frame_start"):
            paths.append(it.path)
            fs.append(it.frame_start)
            fe.append(it.frame_end)
            bbs.append(list(it.bbox) if it.bbox else [_INT_MIN, 0, 0, 0])
        else:
            paths.append(it)
            fs.append(1)
            fe.append(-1)
            bbs.append([_INT_MIN, 0, 0, 0])
    c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    return (c_paths, np.asarray(fs, np.int32), np.asarray(fe, np.int32),
            np.asarray(bbs, np.int32).reshape(-1, 4))


def _batch_out(out, n, num_frames, staging_size, yuv420) -> np.ndarray:
    want = _out(n, num_frames, staging_size, yuv420)
    if out is None:
        return want
    if out.shape != want.shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint8 {want.shape}, got "
                         f"{out.dtype} {out.shape}")
    return out


def decode_batch_native(
    items: Sequence,
    num_frames: int,
    staging_size: Tuple[int, int],
    host_resize_short: int = 0,
    yuv420: bool = False,
    n_threads: int = 4,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A batch on ``n_threads`` native threads, in one call. ``items``:
    paths or clip records (segment and box honoured). Returns (frames
    [N, T, ...], ok [N] int32, 0 where the clip decoded)."""
    lib = _LIBS["opencv"].require()
    n = len(items)
    out = _batch_out(out, n, num_frames, staging_size, yuv420)
    c_paths, fs, fe, bb = _batch_args(items)
    ok = np.empty((n,), np.int32)
    hs, ws = staging_size
    lib.asltpu_decode_batch(c_paths, n, num_frames, hs, ws, host_resize_short,
                            _i32(fs), _i32(fe), _i32(bb), int(yuv420),
                            int(n_threads), _u8(out), _i32(ok))
    return out, ok


def decode_batch_av(
    items: Sequence,
    num_frames: int,
    staging_size: Tuple[int, int],
    host_resize_short: int = 0,
    yuv420: bool = False,
    fast_flags: int = 0,
    n_threads: int = 4,
    out: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`decode_batch_native` on the libav library, plus
    ``fast_flags``."""
    lib = _LIBS["av"].require()
    n = len(items)
    out = _batch_out(out, n, num_frames, staging_size, yuv420)
    c_paths, fs, fe, bb = _batch_args(items)
    ok = np.empty((n,), np.int32)
    hs, ws = staging_size
    lib.asltpu_av_decode_batch(c_paths, n, num_frames, hs, ws, host_resize_short,
                               _i32(fs), _i32(fe), _i32(bb), int(yuv420),
                               int(fast_flags), int(n_threads), _u8(out), _i32(ok))
    return out, ok


def encode_synthetic_av(
    path: str,
    num_frames: int,
    size: Tuple[int, int],
    max_b_frames: int = 0,
    gop_size: int = 12,
    seed: int = 0,
) -> int:
    """Write a deterministic smooth-gradient mpeg4 clip of ``size`` (H, W)
    whose B-frame structure the caller sets (OpenCV's writer emits none).
    Returns the number of reordered packets: nonzero iff B-frames were
    encoded."""
    lib = _LIBS["av"].require()
    h, w = size
    rc = lib.asltpu_av_encode_synthetic(path.encode(), int(num_frames), int(h),
                                        int(w), int(max_b_frames), int(gop_size),
                                        int(seed))
    if rc < 0:
        raise IOError(f"cannot encode synthetic clip: {path}")
    return rc
