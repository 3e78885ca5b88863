"""ctypes bindings for the native C++ data loader (``dataio.cc``; the
JAX package's ``native/loader.py``).

Build: the shared library is compiled on first use with ``g++ -O3
-std=c++17 -shared -fPIC -fopenmp`` into ``build/native/`` at the root of
the checkout, named by the source's sha256, so an edit rebuilds.  Each
process links to a temporary name of its own and publishes with
``os.replace``: two processes (pytest workers, N ranks) that build at
once never see a half-written library.  If the toolchain or the build is
missing, ``available()`` is False and every caller takes its numpy path
(the same results, bit for bit: the randomness is drawn by the caller
either way).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "dataio.cc")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED = False

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


#: Where the library is built: ``build/native`` at the checkout's root.
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "build", "native")


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    return os.path.join(BUILD_DIR, f"dataio-{digest}.so")


def _build(so: str) -> None:
    # A temporary name per process: concurrent builds must not interleave
    # their linker writes; os.replace publishes atomically, whoever ends
    # last.
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    lib.idx_images_dims.argtypes = [_U8, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.idx_images_dims.restype = ctypes.c_int
    lib.idx_images_parse.argtypes = [_U8, ctypes.c_size_t, _F32]
    lib.idx_images_parse.restype = ctypes.c_int
    lib.idx_labels_dims.argtypes = [_U8, ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.idx_labels_dims.restype = ctypes.c_int
    lib.idx_labels_parse.argtypes = [_U8, ctypes.c_size_t, _I32]
    lib.idx_labels_parse.restype = ctypes.c_int
    lib.cifar_parse.argtypes = [_U8, ctypes.c_size_t, _F32, _I32]
    lib.cifar_parse.restype = ctypes.c_int
    lib.gather_f32.argtypes = [_F32, _I64, ctypes.c_int64, ctypes.c_int64,
                               _F32]
    lib.gather_f32.restype = None
    lib.gather_u8.argtypes = [_U8, _I64, ctypes.c_int64, ctypes.c_int64, _U8]
    lib.gather_u8.restype = None
    lib.gather_i32.argtypes = [_I32, _I64, ctypes.c_int64, _I32]
    lib.gather_i32.restype = None
    lib.augment_crop_flip.argtypes = [_F32, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64, _I32,
                                      _I32, _U8, _F32]
    lib.augment_crop_flip.restype = None
    lib.augment_crop_flip_u8.argtypes = [_U8, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64,
                                         _I32, _I32, _U8, _U8]
    lib.augment_crop_flip_u8.restype = None
    lib.gather_augment_f32.argtypes = [_F32, _I64, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int64, _I32, _I32, _U8, _F32]
    lib.gather_augment_f32.restype = None
    lib.gather_augment_u8.argtypes = [_U8, _I64, ctypes.c_int64,
                                      ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_int64, _I32, _I32, _U8, _U8]
    lib.gather_augment_u8.restype = None
    lib.omp_max_threads.argtypes = []
    lib.omp_max_threads.restype = ctypes.c_int


def _get() -> ctypes.CDLL | None:
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        try:
            so = _so_path()
            if not os.path.exists(so):
                _build(so)
            lib = ctypes.CDLL(so)
            _bind(lib)
            _LIB = lib
        except Exception as e:  # toolchain absent, build error, bad cache
            _FAILED = True
            import warnings
            warnings.warn(f"native data loader unavailable, using numpy "
                          f"fallback: {e}")
    return _LIB


def available() -> bool:
    return _get() is not None


def omp_threads() -> int:
    lib = _get()
    return lib.omp_max_threads() if lib else 1


def parse_idx_images(raw: bytes) -> np.ndarray:
    """IDX image bytes -> [N, rows, cols, 1] float32 in [0, 1]."""
    lib = _get()
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = ctypes.c_int64()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.idx_images_dims(buf, buf.size, ctypes.byref(n),
                             ctypes.byref(rows), ctypes.byref(cols))
    if rc:
        raise ValueError(f"bad IDX image data (code {rc})")
    out = np.empty(n.value * rows.value * cols.value, dtype=np.float32)
    rc = lib.idx_images_parse(buf, buf.size, out)
    if rc:
        raise ValueError(f"bad IDX image data (code {rc})")
    return out.reshape(n.value, rows.value, cols.value, 1)


def parse_idx_labels(raw: bytes) -> np.ndarray:
    """IDX label bytes -> [N] int32."""
    lib = _get()
    buf = np.frombuffer(raw, dtype=np.uint8)
    n = ctypes.c_int64()
    rc = lib.idx_labels_dims(buf, buf.size, ctypes.byref(n))
    if rc:
        raise ValueError(f"bad IDX label data (code {rc})")
    out = np.empty(n.value, dtype=np.int32)
    rc = lib.idx_labels_parse(buf, buf.size, out)
    if rc:
        raise ValueError(f"bad IDX label data (code {rc})")
    return out


def parse_cifar(raw: bytes) -> tuple[np.ndarray, np.ndarray]:
    """CIFAR-10 binary record bytes -> ([N,32,32,3] f32 in [0,1], [N] i32)."""
    lib = _get()
    buf = np.frombuffer(raw, dtype=np.uint8)
    if buf.size % 3073:
        raise ValueError("CIFAR binary length not a multiple of 3073")
    n = buf.size // 3073
    images = np.empty((n, 32, 32, 3), dtype=np.float32)
    labels = np.empty(n, dtype=np.int32)
    rc = lib.cifar_parse(buf, buf.size, images.reshape(-1), labels)
    if rc:
        raise ValueError(f"bad CIFAR data (code {rc})")
    return images, labels


def gather(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """out[i] = src[idx[i]] — parallel row gather (f32/u8 ND or i32 1D;
    uint8 moves 4x fewer bytes — the quantized host path)."""
    lib = _get()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if src.dtype == np.int32 and src.ndim == 1:
        out = np.empty(idx.size, dtype=np.int32)
        lib.gather_i32(np.ascontiguousarray(src), idx, idx.size, out)
        return out
    if src.dtype not in (np.float32, np.uint8):
        raise TypeError(f"native gather supports f32/u8/i32, got {src.dtype}")
    src = np.ascontiguousarray(src)
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    out = np.empty((idx.size,) + src.shape[1:], dtype=src.dtype)
    fn = lib.gather_f32 if src.dtype == np.float32 else lib.gather_u8
    fn(src.reshape(-1), idx, idx.size, row, out.reshape(-1))
    return out


def gather_augment(src: np.ndarray, idx: np.ndarray, ys: np.ndarray,
                   xs: np.ndarray, flips: np.ndarray) -> np.ndarray:
    """Fused row gather + reflect-pad-4 crop + hflip for [N,H,W,C] f32 or
    uint8 (dtype-preserving: pure pixel rearrangement)."""
    lib = _get()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    src = np.ascontiguousarray(src)
    if src.dtype not in (np.float32, np.uint8):
        raise TypeError(f"native gather_augment supports f32/u8, "
                        f"got {src.dtype}")
    n, h, w, c = (idx.size,) + src.shape[1:]
    out = np.empty((n, h, w, c), dtype=src.dtype)
    fn = (lib.gather_augment_f32 if src.dtype == np.float32
          else lib.gather_augment_u8)
    fn(src.reshape(-1), idx, n, h, w, c,
       np.ascontiguousarray(ys, dtype=np.int32),
       np.ascontiguousarray(xs, dtype=np.int32),
       np.ascontiguousarray(flips, dtype=np.uint8),
       out.reshape(-1))
    return out


def augment_crop_flip(images: np.ndarray, ys: np.ndarray, xs: np.ndarray,
                      flips: np.ndarray) -> np.ndarray:
    """Reflect-pad-4 random crop + hflip for [N,H,W,C] f32/u8 batches
    (dtype-preserving)."""
    lib = _get()
    images = np.ascontiguousarray(images)
    if images.dtype not in (np.float32, np.uint8):
        raise TypeError(f"native augment supports f32/u8, "
                        f"got {images.dtype}")
    n, h, w, c = images.shape
    out = np.empty_like(images)
    fn = (lib.augment_crop_flip if images.dtype == np.float32
          else lib.augment_crop_flip_u8)
    fn(images.reshape(-1), n, h, w, c,
       np.ascontiguousarray(ys, dtype=np.int32),
       np.ascontiguousarray(xs, dtype=np.int32),
       np.ascontiguousarray(flips, dtype=np.uint8),
       out.reshape(-1))
    return out
