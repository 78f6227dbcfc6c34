"""The build path's device kernels: hand-written CUDA on a CUDA tensor, plain
torch on a CPU tensor.

- ``bucket_histogram`` — rows per bucket of the bucketed covering build
  (CUDA: ``csrc/bucket_histogram.cu``; replaces the Pallas
  ``hyperspace_tpu/ops/kernels.py::_hist_kernel``). One pass, one launch:
  blocks own contiguous tiles read as int4, threads count runs of equal ids
  in registers, and the kernel zeroes the next call's counts.
- ``segment_min_max_keys`` — per-segment min and max order keys behind
  MinMax sketch builds, one segment per source file (CUDA:
  ``csrc/segmented_min_max.cu``; replaces the Pallas ``_minmax_kernel``).
  The grid splits the values, not the segments, so every SM reads an equal
  share whatever the segment lengths; pieces fold into their segment with
  int64 atomics.
  ``segmented_min_max`` is its host driver with the JAX package's contract.

Each wrapper takes the CUDA kernel for a CUDA tensor and the ``*_plain``
torch version for a CPU tensor, and nothing else: a CUDA tensor never falls
back. ``launches`` counts kernel launches per wrapper so a run can show that
its main path went through the kernels.

Both kernels add into their outputs with atomics, so the outputs must
start at zero (counts) or at the identities (keys, empty flags). A fill
launch for that would cost as much as the kernel, so each call's kernel
also initialises the outputs of the next call on its device, which the
wrapper keeps until then: one launch per call. Calls on one device must
therefore be serialised on one stream, as the build's are.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, List, Sequence, Tuple

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


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong  # pointer, int, int64
#: (library, launcher) per launcher name, resolved and typed once
_launchers: Dict[str, Tuple[ctypes.CDLL, object]] = {}
#: SM count per device index, read once
_sm_counts: Dict[int, int] = {}
#: per device: the outputs of the next call of each kernel, which the last
#: call's kernel initialised (zero counts; identity keys and empty flags)
_zeroed_counts: Dict[int, torch.Tensor] = {}
_initialised_outputs: Dict[int, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def _launcher(source: str, name: str, argtypes):
    """The launcher ``name`` from the library of ``source`` (built at first
    use), its argument types set once per process; it returns a CUDA error
    code."""
    found = _launchers.get(name)
    if found is None:
        lib = cuda_build.load(source)
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        found = _launchers[name] = (lib, fn)
    return found


def _sm_count(device: torch.device) -> int:
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device.index]


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
    lib, fn = _launcher("bucket_histogram.cu", "hs_bucket_histogram", [_P, _LL, _I, _P, _P, _I, _P])
    if ids.numel() == 0:
        return torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
    with torch.cuda.device(ids.device):
        # the kernel adds into counts that the previous call's kernel zeroed
        # and zeroes the counts of the next call
        counts = _zeroed_counts.pop(ids.device.index, None)
        if counts is None or counts.numel() != num_buckets:
            counts = torch.zeros(num_buckets, dtype=torch.int32, device=ids.device)
        following = torch.empty(num_buckets, dtype=torch.int32, device=ids.device)
        code = fn(ids.data_ptr(), ids.numel(), num_buckets, counts.data_ptr(), following.data_ptr(),
                  _sm_count(ids.device), _stream())
    cuda_build.check(lib, code, "bucket_histogram")
    _zeroed_counts[ids.device.index] = following
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
    lib, fn = _launcher("segmented_min_max.cu", "hs_segmented_min_max",
                        [_P, _LL, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _P])
    n_seg = offsets.numel() - 1
    dev = values.device
    if n_seg == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev), torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=torch.bool, device=dev))
    with torch.cuda.device(dev):
        # the kernel folds into outputs that the previous call's kernel set
        # to the identities, and sets up as many for the next call
        outs = _initialised_outputs.pop(dev.index, None)
        if outs is None or outs[0].numel() < n_seg:
            outs = (torch.full((n_seg,), I64_MAX, dtype=torch.int64, device=dev),
                    torch.full((n_seg,), I64_MIN, dtype=torch.int64, device=dev),
                    torch.ones(n_seg, dtype=torch.bool, device=dev))
        following = (torch.empty(n_seg, dtype=torch.int64, device=dev),
                     torch.empty(n_seg, dtype=torch.int64, device=dev),
                     torch.empty(n_seg, dtype=torch.bool, device=dev))
        code = fn(values.data_ptr(), values.numel(), offsets.data_ptr(), n_seg,
                  *(t.data_ptr() for t in outs), *(t.data_ptr() for t in following), n_seg,
                  _sm_count(dev), _stream())
    cuda_build.check(lib, code, "segmented_min_max")
    _initialised_outputs[dev.index] = following
    launches["segmented_min_max"] += 1
    return tuple(t[:n_seg] for t in outs)


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
