"""The build path's device kernels: hand-written CUDA on a CUDA tensor, plain
torch on a CPU tensor.

- ``bucket_histogram`` — rows per bucket of the bucketed covering build
  (CUDA: ``csrc/bucket_histogram.cu``; replaces the Pallas
  ``hyperspace_tpu/ops/kernels.py::_hist_kernel``).
- ``segment_min_max_keys`` — per-segment min and max order keys behind
  MinMax sketch builds, one segment per source file (CUDA:
  ``csrc/segmented_min_max.cu``; replaces the Pallas ``_minmax_kernel``).
  ``segmented_min_max`` is its host driver with the JAX package's contract.

Each wrapper takes the CUDA kernel for a CUDA tensor and the ``*_plain``
torch version for a CPU tensor, and nothing else: a CUDA tensor never falls
back. ``launches`` counts kernel launches per wrapper so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from hyperspace_tpu_torch.ops import cuda_build

#: kernel launches per wrapper name since the last ``reset_launches()``
launches: collections.Counter = collections.Counter()

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


def reset_launches() -> None:
    launches.clear()


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _require(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous 1-D {dtype} tensor, got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# bucket histogram
# ---------------------------------------------------------------------------


def bucket_histogram_plain(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    ok = (ids >= 0) & (ids < num_buckets)
    return torch.bincount(ids[ok].to(torch.int64), minlength=num_buckets).to(torch.int32)


def bucket_histogram(ids: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Rows per bucket of a 1-D int32 id tensor: int32 ``(num_buckets,)`` on
    the ids' device. Ids outside ``[0, num_buckets)`` count nowhere."""
    _require(ids, torch.int32, "bucket ids")
    if ids.device.type == "cpu":
        return bucket_histogram_plain(ids, num_buckets)
    counts = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    if ids.numel() == 0:
        return counts
    lib = cuda_build.load("bucket_histogram.cu")
    fn = lib.hs_bucket_histogram
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(ids.device):
        code = fn(ids.data_ptr(), ids.numel(), num_buckets, counts.data_ptr(), _stream())
    cuda_build.check(lib, code, "bucket_histogram")
    launches["bucket_histogram"] += 1
    return counts


# ---------------------------------------------------------------------------
# segmented min/max
# ---------------------------------------------------------------------------
#
# The order key of a float64: its bits b as int64 for b >= 0, b ^ INT64_MAX
# for b < 0. Signed key order is the IEEE total order (-0.0 < +0.0), and the
# map is its own inverse on the bits. INT64_MAX / INT64_MIN are keys of NaN
# bit patterns only, so they are the identities of min / max.


def order_keys(values: torch.Tensor) -> torch.Tensor:
    bits = values.view(torch.int64)
    return torch.where(bits < 0, bits ^ I64_MAX, bits)


def keys_to_f64(keys: np.ndarray) -> np.ndarray:
    keys = np.asarray(keys, dtype=np.int64)
    return np.where(keys < 0, keys ^ np.int64(I64_MAX), keys).view(np.float64)


def segment_min_max_keys_plain(values: torch.Tensor, offsets: torch.Tensor):
    n_seg = offsets.numel() - 1
    seg = torch.repeat_interleave(
        torch.arange(n_seg, device=values.device), offsets[1:] - offsets[:-1]
    )
    ok = ~torch.isnan(values)
    keys, seg = order_keys(values)[ok], seg[ok]
    mins = torch.full((n_seg,), I64_MAX, dtype=torch.int64, device=values.device)
    maxs = torch.full((n_seg,), I64_MIN, dtype=torch.int64, device=values.device)
    mins = mins.scatter_reduce(0, seg, keys, "amin")
    maxs = maxs.scatter_reduce(0, seg, keys, "amax")
    return mins, maxs, mins == I64_MAX


def segment_min_max_keys(values: torch.Tensor, offsets: torch.Tensor):
    """Per-segment ``(min_keys, max_keys, empty)`` of float64 ``values`` in
    CSR layout (segment ``s`` is ``values[offsets[s]:offsets[s+1]]``, int64
    offsets). NaN is skipped; a segment with nothing else is ``empty`` and
    its keys are the identities."""
    _require(values, torch.float64, "values")
    _require(offsets, torch.int64, "offsets")
    if values.device != offsets.device:
        raise ValueError("values and offsets must be on one device")
    if values.device.type == "cpu":
        return segment_min_max_keys_plain(values, offsets)
    n_seg = offsets.numel() - 1
    mins = torch.empty(n_seg, dtype=torch.int64, device=values.device)
    maxs = torch.empty(n_seg, dtype=torch.int64, device=values.device)
    empty = torch.empty(n_seg, dtype=torch.bool, device=values.device)
    if n_seg == 0:
        return mins, maxs, empty
    lib = cuda_build.load("segmented_min_max.cu")
    fn = lib.hs_segmented_min_max
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(values.device):
        code = fn(values.data_ptr(), offsets.data_ptr(), n_seg, mins.data_ptr(),
                  maxs.data_ptr(), empty.data_ptr(), _stream())
    cuda_build.check(lib, code, "segmented_min_max")
    launches["segmented_min_max"] += 1
    return mins, maxs, empty


# Cap on values per device call; segments are split / grouped so one huge
# file can never force one oversized upload.
_MINMAX_CALL_ELEMS = 1 << 23
_MAX_PIECE = _MINMAX_CALL_ELEMS // 8


def segmented_min_max(segments: Sequence[np.ndarray], device) -> Tuple[np.ndarray, np.ndarray]:
    """Per-segment (min, max) of variable-length numeric segments.

    ``segments`` is a list of 1-D numpy arrays (one per source file). NaNs
    (SQL nulls) are ignored, matching Min/Max aggregate semantics. Returns
    (mins, maxs) as float64 numpy arrays of length ``len(segments)``;
    all-null/empty segments yield (nan, nan). Exact over the full f64 range:
    the device compares order keys, not floats. Each segment is taken as
    ``np.asarray(s, dtype=np.float64)``, as the JAX package takes it.

    Memory-bounded: oversized segments are split into pieces and pieces are
    grouped into device calls of at most ``_MINMAX_CALL_ELEMS`` values;
    per-piece results fold together exactly on the host (each piece result
    is already an exact element of the segment).
    """
    n = len(segments)
    mins = np.full(n, np.nan)
    maxs = np.full(n, np.nan)
    pieces: List[Tuple[int, np.ndarray]] = []
    for i, s in enumerate(segments):
        s = np.asarray(s, dtype=np.float64)
        for off in range(0, max(s.shape[0], 1), _MAX_PIECE):
            pieces.append((i, s[off : off + _MAX_PIECE]))

    group: List[Tuple[int, np.ndarray]] = []
    group_elems = 0

    def flush() -> None:
        offsets = np.zeros(len(group) + 1, dtype=np.int64)
        np.cumsum([p.shape[0] for _, p in group], out=offsets[1:])
        values = torch.from_numpy(np.concatenate([p for _, p in group])).to(device)
        mn, mx, empty = segment_min_max_keys(values, torch.from_numpy(offsets).to(device))
        empty = empty.cpu().numpy()
        g_mins = np.where(empty, np.nan, keys_to_f64(mn.cpu().numpy()))
        g_maxs = np.where(empty, np.nan, keys_to_f64(mx.cpu().numpy()))
        for (idx, _), lo, hi in zip(group, g_mins, g_maxs):
            mins[idx] = np.fmin(mins[idx], lo)
            maxs[idx] = np.fmax(maxs[idx], hi)

    for idx, p in pieces:
        if group and group_elems + p.shape[0] > _MINMAX_CALL_ELEMS:
            flush()
            group, group_elems = [], 0
        group.append((idx, p))
        group_elems += p.shape[0]
    if group:
        flush()
    return mins, maxs
