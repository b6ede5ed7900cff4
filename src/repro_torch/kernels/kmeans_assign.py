"""Fused K-means assignment + partial sums (the paper's ``partial_sum``
task): the port of ``repro/kernels/kmeans_assign.py``.

Two versions of one function, with the Pallas kernel's semantics, in
fp32: each point goes to ``argmax_c (x·c − ½|c|²)`` (the first index on
ties); the outputs are the per-cluster sums ``(k, d)``, the counts
``(k,)`` int32 and ``sse = Σ (|x|² − 2·best)`` as a 0-d tensor.

* :func:`kmeans_assign_plain` — plain PyTorch (the one-hot contraction
  of the Pallas kernel).  The CPU tests use it, and ``chip_smoke.py``
  holds the kernel against it.
* :func:`kmeans_assign_cuda` — the hand-written CUDA kernel
  (``csrc/kmeans_assign.cu``, which documents its design and bound): two
  persistent blocks per SM stream tiles of points through two-stage
  ``cp.async`` rings and run both products on the tensor cores: the scores
  ``x·c`` in 3xTF32 (fp32-grade), the per-cluster sums as a one-hot
  contraction (each point split into TF32 hi + lo, within ~2⁻²² of
  fp32) — for k <= 64 and d <= 256; every other k and d take the wide
  route (the same 3xTF32 scores with both operands streamed in 32-deep
  slices, over centroid tiles of 16; each tile's points sorted by
  cluster and added in point order into per-block partials, merged in
  block order).  :func:`route` picks one by shape before launch, and a
  route that fails raises: neither hands work to the other or to the
  plain version.  Both are deterministic (no float atomics) and take
  contiguous fp32 CUDA tensors; the wrapper raises on anything else.

:func:`repro_torch.kernels.ops.kmeans_assign` picks one by device.
"""
from __future__ import annotations

import math

import torch

from . import _build

_THREADS = 256        # threads per block (kThreads in csrc/kmeans_assign.cu)
_WARPS = _THREADS // 32
_STAGES = 2           # tiles in the shared ring (kStages)
_BLOCKS_PER_SM = 2    # persistent blocks per SM
MAX_K = 64            # the tensor-core route's sums of one warp stay in
MAX_D = 256           # registers: at most 4 x 16 clusters by 4 x 8 dims
_SMEM_PER_SM = 233472  # shared memory of one Hopper SM
_SMEM_LIMIT = 232448   # dynamic shared memory a Hopper block may use
# the wide route (any k and d): tiles of 128 points, centroids in passes
# of up to 128, 32-deep slices of both in a ring of 3 shared stages, the
# tile's sort keys and segments, and the block's partials in shared
# memory where they fit beside those
WIDE_POINTS = 128       # kWidePoints in csrc/kmeans_assign.cu
WIDE_SCRATCH_FLOATS = 1 << 22   # the wide route's partials, unless one is larger


def _check_shapes(x, centroids) -> None:
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(f"kmeans_assign takes x (n, d) and centroids (k, d), got "
                         f"{tuple(x.shape)} and {tuple(centroids.shape)}")
    if x.shape[0] < 1 or centroids.shape[0] < 1:
        raise ValueError("kmeans_assign needs at least one point and one centroid")


def kmeans_assign_plain(x: torch.Tensor, centroids: torch.Tensor):
    """Plain PyTorch version.  Returns (sums (k, d) fp32, counts (k,)
    int32, sse 0-d fp32)."""
    _check_shapes(x, centroids)
    xf = x.to(torch.float32)
    c = centroids.to(torch.float32)
    half = xf @ c.T - 0.5 * (c * c).sum(1)[None, :]
    best = half.amax(dim=1)
    assign = torch.argmax(half, dim=1)     # the first index on ties
    onehot = torch.nn.functional.one_hot(assign, c.shape[0]).to(torch.float32)
    sums = onehot.T @ xf
    counts = onehot.sum(0).to(torch.int32)
    sse = ((xf * xf).sum(1) - 2.0 * best).sum()
    return sums, counts, sse


def _stage_floats(T: int, d: int) -> int:
    return (T * d + 12 + 3) // 4 * 4


def _padded_k(k: int) -> int:
    """Clusters padded to the kernel's m-tiles: 16, 32 or 64."""
    return 16 if k <= 16 else (32 if k <= 32 else 64)


def smem_bytes(k: int, d: int, T: int = None) -> int:
    """Dynamic shared memory of one kernel block (see the .cu source):
    the ring of tiles, the centroids as TF32 hi/lo fragments (16 bytes per
    lane, 8-cluster slice and 8-dim step), |c|²/2, the tile's assignments,
    the block's counts and the per-warp sse."""
    T = tile_points(k, d) if T is None else T
    kp = _padded_k(k)
    return (4 * (_STAGES * _stage_floats(T, d) + kp + T + kp + _WARPS)
            + (kp // 16) * -(-d // 8) * 64 * 16)


def tile_points(k: int, d: int) -> int:
    """Points per tile: 256, halved (to 32 at least) until two blocks fit
    one SM's shared memory (each with 1 KB the card reserves)."""
    T = 256
    while T > 32 and _BLOCKS_PER_SM * (smem_bytes(k, d, T) + 1024) > _SMEM_PER_SM:
        T //= 2
    return T


def mma_chains(k: int, d: int) -> int:
    """Independent accumulators per output tile in the kernel (kChains):
    4 where a warp owns one 16 x 8 tile of the sums, 2 where it owns two
    or three, else 1."""
    tiles = (_padded_k(k) // 16) * next(q for q in (1, 2, 4) if 8 * _WARPS * q >= d)
    return 1 if tiles >= 4 else (2 if tiles >= 2 else 4)


def route(k: int, d: int) -> str:
    """The CUDA route for k centroids of d dims: ``"tensor_cores"`` within
    the tensor-core kernel's registers, else ``"wide"`` (the depth-streamed
    route, any k and d)."""
    return "tensor_cores" if k <= MAX_K and d <= MAX_D else "wide"


def wide_pass(k: int) -> int:
    """Centroids per pass of the wide route's scores (8 NT): k rounded up
    to 16, at most 128."""
    return min(128, -(-k // 16) * 16)


def wide_blocks_per_sm(k: int) -> int:
    """Wide-route blocks an SM holds by registers: two up to 96 centroids
    a pass, one past that (its ``__launch_bounds__``)."""
    return 2 if wide_pass(k) <= 96 else 1


def wide_ring_bytes(k: int) -> int:
    """The wide route's ring: 3 stages of a 32-deep slice of 128 points
    and of one pass's centroid rows, row stride 36 floats, and those
    centroids' |c|^2/2.  It does not depend on d."""
    nb = wide_pass(k)
    return 3 * ((WIDE_POINTS + nb) * 36 + nb) * 4


def wide_smem(k: int, d: int) -> tuple:
    """(dynamic shared memory of one wide-route block, whether the block's
    partials — k x d sums, k counts — are in it): the ring, the tile's 128
    sort keys and 272 ints of assignments, segments and sse slots, plus
    the partials where they fit, else those stay in global scratch."""
    base = wide_ring_bytes(k) + WIDE_POINTS * 8 + 272 * 4
    with_partials = base + 4 * (k * d + k)
    if with_partials <= _SMEM_LIMIT:
        return with_partials, True
    return base, False


def wide_blocks(n: int, k: int, d: int, sms: int) -> int:
    """Persistent blocks of the wide route: one per tile of 128 points at
    most, as many as the SMs hold (by registers and shared memory), and
    so that the partials (k*d + k + 1 floats per block) stay within
    ``WIDE_SCRATCH_FLOATS`` (one block where one partial is larger)."""
    per_sm = max(1, min(wide_blocks_per_sm(k), _SMEM_PER_SM // (wide_smem(k, d)[0] + 1024)))
    per_block = k * d + k + 1
    return max(1, min(math.ceil(n / WIDE_POINTS), per_sm * sms,
                      WIDE_SCRATCH_FLOATS // per_block))


def kmeans_assign_cuda(x: torch.Tensor, centroids: torch.Tensor):
    """Launch the CUDA kernels of :func:`route`'s choice.  x (n, d) and
    centroids (k, d) fp32, contiguous, on one CUDA device.  Returns (sums
    (k, d) fp32, counts (k,) int32, sse 0-d fp32)."""
    _build.refuse_grad("kmeans_assign_cuda", x, centroids)
    _check_shapes(x, centroids)
    dev = _build.require("kmeans_assign_cuda", [("x", x, (torch.float32,)),
                                                ("centroids", centroids, (torch.float32,))])
    (n, d), k = x.shape, centroids.shape[0]
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.int32, device=dev)
    sse = torch.empty((), dtype=torch.float32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    outs = (sums.data_ptr(), counts.data_ptr(), sse.data_ptr())
    if route(k, d) == "tensor_cores":
        T = tile_points(k, d)
        blocks = min(math.ceil(n / T), _BLOCKS_PER_SM * sms)
        part_sums = torch.empty((blocks, k, d), dtype=torch.float32, device=dev)
        part_counts = torch.empty((blocks, k), dtype=torch.int32, device=dev)
        part_sse = torch.empty((blocks,), dtype=torch.float32, device=dev)
        _build.launch("kmeans_assign", "kmeans_assign_launch", dev,
                      x.data_ptr(), centroids.data_ptr(), n, k, d, T, blocks,
                      part_sums.data_ptr(), part_counts.data_ptr(), part_sse.data_ptr(), *outs)
    else:
        smem, shared_partials = wide_smem(k, d)
        blocks = wide_blocks(n, k, d, sms)
        hc = torch.empty((k,), dtype=torch.float32, device=dev)
        part_sums = torch.empty((blocks, k, d), dtype=torch.float32, device=dev)
        part_counts = torch.empty((blocks, k), dtype=torch.int32, device=dev)
        part_sse = torch.empty((blocks,), dtype=torch.float32, device=dev)
        _build.launch("kmeans_assign", "kmeans_wide_launch", dev,
                      x.data_ptr(), centroids.data_ptr(), n, k, d,
                      _build.copy_width(d, x, centroids), blocks, int(shared_partials), smem,
                      hc.data_ptr(), part_sums.data_ptr(), part_counts.data_ptr(),
                      part_sse.data_ptr(), *outs)
    return sums, counts, sse
