"""The native host runtime: port of apex_example_tpu/host_runtime.py
(``flatten_f32`` :106, ``unflatten_f32`` :130, ``gen_u8`` :155,
``collate_f32`` :166, ``NativePrefetcher`` :184, ``NativeLMPrefetcher``
:271) over the port's own copy of its C++ source,
``csrc/host_runtime.cpp``.

The library is built at first use with g++ and csrc/Makefile's flags
(``-O3 -std=c++17 -fPIC -shared -lpthread``) into ``build/kernels/``,
beside the CUDA libraries (ops/_build.py), under a name that hashes the
source and the flags; nothing is built or loaded when the module is
imported.  ``available()`` says whether it could be built.

The prefetchers are the trainer's ``--host-pipeline``: a C++ worker thread
makes batch i + 1 while the card runs batch i, deterministic in (seed,
batch index), and ``start_index`` continues a stream where a resumed run
stopped; ``rows`` makes only a slice of every batch's rows, the same bytes
as those rows of the whole batch (one data-parallel process's share).
Their batches are CPU tensors, and with ``pin_memory=True`` they
lie in page-locked memory, so the trainer's ``.to(device,
non_blocking=True)`` is an asynchronous copy.  Every ``next()`` writes
into fresh tensors: a pinned block that a queued copy still reads goes
back into PyTorch's pinned-memory cache only when that copy has
finished, so no batch is overwritten in flight.  (JAX's ``copy=False``,
views of two buffers that the next call overwrites, is not ported: an
asynchronous copy out of them would race the next ``next()``.)
Every function raises where the library cannot be built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_example_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "host_runtime.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

# The data the JAX trainer's prefetchers make: ImageNet's per-channel
# mean and std, BERT's 15% masking, and the LM streams' 10% noise flips.
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
MASK_PROB = 0.15
NOISE_P = 0.1


def library_path() -> Path:
    """Where the library built from ``csrc/host_runtime.cpp`` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libhost_runtime-{digest}.so"


def build() -> Optional[Path]:
    """Compile the library unless it is built; returns its path, or None
    when there is no C++ compiler (``$CXX``, default g++) or it fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                        "-lpthread"], check=True, capture_output=True,
                       timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def _library() -> Optional[ctypes.CDLL]:
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    i64, u64, i32, vp = (ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32,
                         ctypes.c_void_p)
    for name, res, args in (
            ("apex_flatten_f32", i64, [vp, vp, i64, vp]),
            ("apex_unflatten_f32", i64, [vp, vp, vp, i64]),
            ("apex_gen_u8", None, [u64, u64, vp, i64]),
            ("apex_collate_f32", None, [vp, i64, i64, i64, vp, vp, vp]),
            ("apex_prefetcher_new", vp, [i64, i64, i64, i64, u64, vp, vp,
                                         i64, i64, i64]),
            ("apex_prefetcher_next", i64, [vp, vp, vp]),
            ("apex_prefetcher_free", None, [vp]),
            ("apex_lm_prefetcher_new", vp, [i64, i64, i64, u64, i64, i32,
                                            i32, ctypes.c_float,
                                            ctypes.c_float, i64, i64]),
            ("apex_lm_prefetcher_next", i64, [vp, vp, vp, vp]),
            ("apex_lm_prefetcher_free", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def available() -> bool:
    """True when the library is built or could be built now."""
    return _library() is not None


def _required() -> ctypes.CDLL:
    lib = _library()
    if lib is None:
        raise RuntimeError("native host runtime unavailable (g++ build "
                           "failed?)")
    return lib


# ---------------------------------------------------------------- apex_C


def flatten_f32(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate float32 arrays into one contiguous fp32 buffer."""
    lib = _required()
    arrays = [np.ascontiguousarray(a, dtype=np.float32) for a in arrays]
    if not arrays:
        return np.empty(0, np.float32)
    sizes = np.asarray([a.size for a in arrays], np.int64)
    out = np.empty(int(sizes.sum()), np.float32)
    srcs = np.asarray([a.ctypes.data for a in arrays], np.uint64)
    n = lib.apex_flatten_f32(srcs.ctypes.data, sizes.ctypes.data,
                             len(arrays), out.ctypes.data)
    if n != out.size:
        raise RuntimeError(f"flatten copied {n} of {out.size} floats")
    return out


def unflatten_f32(flat: np.ndarray,
                  shapes: Sequence[Tuple[int, ...]]) -> List[np.ndarray]:
    """Scatter a contiguous fp32 buffer back into arrays of ``shapes``."""
    lib = _required()
    flat = np.ascontiguousarray(flat, dtype=np.float32)
    outs = [np.empty(s, np.float32) for s in shapes]
    sizes = np.asarray([o.size for o in outs], np.int64)
    if int(sizes.sum()) != flat.size:
        raise ValueError(f"shapes hold {int(sizes.sum())} floats, the "
                         f"buffer {flat.size}")
    dsts = np.asarray([o.ctypes.data for o in outs], np.uint64)
    lib.apex_unflatten_f32(flat.ctypes.data, dsts.ctypes.data,
                           sizes.ctypes.data, len(outs))
    return outs


# ------------------------------------------------- generator and collate


def gen_u8(seed: int, start_index: int, n: int) -> np.ndarray:
    """``n`` uint8 values of the splitmix64 stream at (seed, index)."""
    out = np.empty(n, np.uint8)
    _required().apex_gen_u8(seed, start_index, out.ctypes.data, n)
    return out


def collate_f32(frames_u8: np.ndarray, mean: Sequence[float],
                std: Sequence[float]) -> np.ndarray:
    """uint8 [N, H, W, C] -> normalized float32 NHWC (fast_collate)."""
    lib = _required()
    frames_u8 = np.ascontiguousarray(frames_u8, dtype=np.uint8)
    n, h, w, c = frames_u8.shape
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    out = np.empty((n, h, w, c), np.float32)
    lib.apex_collate_f32(frames_u8.ctypes.data, n, h * w, c,
                         mean.ctypes.data, std.ctypes.data, out.ctypes.data)
    return out


# ------------------------------------------------------------ prefetchers


def _row_range(rows: Optional[slice], batch: int) -> Tuple[int, int]:
    """(first row, row count) of ``rows`` of a ``batch``-row batch."""
    start, stop, step = (rows or slice(None)).indices(batch)
    if step != 1 or stop <= start:
        raise ValueError(f"rows {rows} is not a contiguous, non-empty "
                         f"slice of {batch} rows")
    return start, stop - start


class _Producer:
    """A handle on one C++ producer: iteration, ``close`` (joins its
    worker thread), and the context-manager protocol."""

    _free = ""

    def __iter__(self):
        return self

    def close(self) -> None:
        if self._h is not None:
            getattr(self._lib, self._free)(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):  # pragma: no cover
        self.close()


class NativePrefetcher(_Producer):
    """Double-buffered background producer of normalized synthetic image
    batches: ``next()`` gives ``(images, labels)``, fresh fp32 NHWC [B, S,
    S, C] and int32 [B] CPU tensors (pinned with ``pin_memory``); with
    ``rows``, those rows of each batch only (``self.rows`` of them)."""

    _free = "apex_prefetcher_free"

    def __init__(self, batch: int, image_size: int, num_classes: int,
                 channels: int = 3, seed: int = 0, start_index: int = 0,
                 rows: Optional[slice] = None, pin_memory: bool = False):
        self._h = None
        lib = _required()
        row0, n = _row_range(rows, batch)
        self._lib, self._pin, self.rows = lib, pin_memory, n
        self._shape = (n, image_size, image_size, channels)
        mean = np.asarray(MEAN[:channels], np.float32)
        std = np.asarray(STD[:channels], np.float32)
        self._h = lib.apex_prefetcher_new(
            batch, image_size * image_size, channels, num_classes, seed,
            mean.ctypes.data, std.ctypes.data, start_index, row0, n)

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._h is None:
            raise StopIteration
        img = torch.empty(self._shape, dtype=torch.float32,
                          pin_memory=self._pin)
        lab = torch.empty(self._shape[0], dtype=torch.int32,
                          pin_memory=self._pin)
        self._lib.apex_prefetcher_next(self._h, img.data_ptr(),
                                       lab.data_ptr())
        return img, lab


class NativeLMPrefetcher(_Producer):
    """Background producer of LM / masked-LM token batches: ``next()``
    gives ``(input_ids, labels, weights)``, int32 / int32 / float32
    [batch, seq_len] CPU tensors (pinned with ``pin_memory``), fresh at
    every call; with ``rows``, those rows of each batch only (``self.rows``
    of them).  ``mlm=True``: BERT's 15% / 80-10-10 masking, labels the
    original tokens, weights 1.0 at the masked positions; ``mlm=False``:
    next-token targets, weights all ones."""

    _free = "apex_lm_prefetcher_free"

    def __init__(self, batch: int, seq_len: int, vocab_size: int,
                 mlm: bool, mask_token_id: int = -1, seed: int = 0,
                 start_index: int = 0, rows: Optional[slice] = None,
                 pin_memory: bool = False):
        self._h = None
        lib = _required()
        if mlm and mask_token_id < 0:
            raise ValueError("mlm=True needs a mask_token_id")
        row0, n = _row_range(rows, batch)
        self._lib, self._pin, self.rows = lib, pin_memory, n
        self._shape = (n, seq_len)
        self._h = lib.apex_lm_prefetcher_new(
            batch, seq_len, vocab_size, seed, start_index, int(mlm),
            mask_token_id, MASK_PROB, NOISE_P, row0, n)

    def __next__(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        if self._h is None:
            raise StopIteration
        ids, lab = (torch.empty(self._shape, dtype=torch.int32,
                                pin_memory=self._pin) for _ in range(2))
        w = torch.empty(self._shape, dtype=torch.float32,
                        pin_memory=self._pin)
        self._lib.apex_lm_prefetcher_next(self._h, ids.data_ptr(),
                                          lab.data_ptr(), w.data_ptr())
        return ids, lab, w
