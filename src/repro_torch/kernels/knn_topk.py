"""Fused distance + running top-k for the paper's ``KNN_frag`` hot loop:
the port of ``repro/kernels/knn_topk.py``.

Two versions of one function, with the Pallas kernel's semantics: fp32
squared distances ``(|x|² − 2x·y) + |y|²``, the k smallest per test row in
ascending order with their training labels, equal distances ordered by
training index (lower first).

* :func:`knn_topk_plain` — plain PyTorch.  It streams over training
  blocks exactly as the Pallas grid does: the running best is placed
  before each new block and a *stable* sort keeps the first k, so the
  lower index wins ties.  It runs wherever its tensors live; the CPU
  tests use it, and ``chip_smoke.py`` holds the kernel against it.
* :func:`knn_topk_cuda` — the hand-written CUDA kernels
  (``csrc/knn_topk.cu``, which documents their design and bound).  For
  k <= 32 and d <= 64 the Hopper route: one persistent block per SM
  walks balanced work units of (128 test rows x 64 training rows); a
  producer warpgroup bulk-copies the training tiles into a ring of shared
  stages and splits each once into TF32 hi/lo planes, two consumer
  warpgroups take the cross term in 3xTF32 ``wgmma`` and the distances,
  and a selector warpgroup keeps each test row's k best with the lower
  training index first on ties, behind a threshold the consumers test
  first; the segments' lists merge as 64-bit keys (distance, index).
  Every other k and d take the wide route: the same 3xTF32 product with
  both operands streamed in 32-deep slices (shared memory independent of
  d), keyed lists.  :func:`route`
  picks one by shape before launch, and a route that fails raises:
  neither hands work to the other or to the plain version.  It takes
  only contiguous fp32 CUDA tensors and raises on anything else.

:func:`repro_torch.kernels.ops.knn_topk` picks one by device.
"""
from __future__ import annotations

import math

import torch

from . import _build

BIG = 1e30
MAX_K = 32             # the merge's register list lengths: 8/16/32
# the tensor-core route's depth: its consumers hold the test rows' TF32
# fragments in registers, 8 a step of 8; at d 64 it takes 3.99 / 7.15-7.19
# ms at k 5 / 32 against the wide route's 5.71 / 8.34-8.42, which takes d
# 72 in 6.86 / 9.47-9.49 (``chip_knockout.py --crossover``)
MAX_D = 64
# the tensor-core route (kTc* in csrc/knn_topk.cu): slabs of 128 test rows
# by tiles of 64 training rows; per block three split stages (hi and lo
# planes of 8-deep steps, 2 KB each, and the tile's |y|^2), three raw
# stages (the tile as copied, 16 bytes of room, |y|^2), two consumer
# warpgroups' distance tiles (two each where they fit), the selector's
# lists, thresholds, flags and 17 mbarriers
TC_ROWS = 128
TC_TILE = 64
TC_SPLIT_STAGES = 3
TC_RAW_STAGES = 3
TC_DIST_LD = TC_TILE + 4
_SMEM_LIMIT = 232448   # dynamic shared memory a Hopper block may use
# the wide route (any k and d): blocks of 128 test rows by tiles of 128
# training rows, 32-deep slices of both (and the tile's |y|^2) in a ring
# of 3 shared stages (WIDE_RING_BYTES, whatever d is), a buffer of 32
# keys per test row, and the rows' lists of k keys in shared memory where
# they fit beside those
WIDE_ROWS = 128        # kWideRows in csrc/knn_topk.cu
WIDE_TILE = 128        # kWideTile
WIDE_RING_BYTES = 3 * ((WIDE_ROWS + WIDE_TILE) * 36 + WIDE_TILE) * 4
WIDE_BUF_BYTES = WIDE_ROWS * 32 * 8
WIDE_MAX_SPLITS = 64
WIDE_MIN_TILES = 64    # a split's least tiles: each split fills its lists anew
WIDE_SCRATCH_KEYS = 1 << 24   # the splits' lists (8 bytes a key), unless one split is larger

ROUTES = ("tensor_cores", "wide")   # the CUDA routes, each counted apart by _build


def _check_shapes(test_x, train_x, train_y, k: int) -> None:
    if test_x.dim() != 2 or train_x.dim() != 2 or train_y.dim() != 1:
        raise ValueError("knn_topk takes test_x (m, d), train_x (n, d), train_y (n,)")
    if test_x.shape[1] != train_x.shape[1] or train_y.shape[0] != train_x.shape[0]:
        raise ValueError(
            f"knn_topk shape mismatch: test {tuple(test_x.shape)}, train "
            f"{tuple(train_x.shape)}, labels {tuple(train_y.shape)}")
    if test_x.shape[0] < 1:
        raise ValueError("knn_topk needs at least one test row")
    if not 1 <= k <= train_x.shape[0]:
        raise ValueError(f"knn_topk needs 1 <= k <= n_train, got k={k}, "
                         f"n_train={train_x.shape[0]}")


def knn_topk_plain(test_x: torch.Tensor, train_x: torch.Tensor,
                   train_y: torch.Tensor, k: int, *, block_n: int = 8192):
    """Plain PyTorch version.  Computes in fp32 (fp64 when an input is
    fp64).  Returns (dists (m, k), labels (m, k) int32)."""
    _check_shapes(test_x, train_x, train_y, k)
    dt = torch.float64 if torch.float64 in (test_x.dtype, train_x.dtype) else torch.float32
    x = test_x.to(dt)
    m = x.shape[0]
    xsq = (x * x).sum(1)[:, None]
    best_d = torch.full((m, k), BIG, dtype=dt, device=x.device)
    best_l = torch.zeros((m, k), dtype=torch.int32, device=x.device)
    for b0 in range(0, train_x.shape[0], block_n):
        y = train_x[b0:b0 + block_n].to(dt)
        d2 = (xsq - 2.0 * (x @ y.T)) + (y * y).sum(1)[None, :]
        lab = train_y[b0:b0 + block_n].to(torch.int32)[None, :].expand(m, -1)
        cand_d = torch.cat([best_d, d2], dim=1)
        cand_l = torch.cat([best_l, lab], dim=1)
        order = torch.sort(cand_d, dim=1, stable=True).indices[:, :k]
        best_d = torch.gather(cand_d, 1, order)
        best_l = torch.gather(cand_l, 1, order)
    return best_d, best_l


def tc_layout(d: int, k: int) -> tuple:
    """(dynamic shared memory of one tensor-core-route block, its distance
    tiles per consumer warpgroup): ``tc_layout`` in ``csrc/knn_topk.cu``."""
    steps, kb = -(-d // 8), list_length(k)
    split_stage = 2 * steps * TC_TILE * 8 * 4 + TC_TILE * 4
    raw_stage = -(-(TC_TILE * d * 4 + 16) // 16) * 16 + TC_TILE * 4
    stages = TC_SPLIT_STAGES * split_stage + TC_RAW_STAGES * raw_stage
    for bufs in (2, 1):
        total = (stages + 2 * bufs * 64 * TC_DIST_LD * 4 + 2 * TC_ROWS * (kb + 1) * 4
                 + TC_ROWS * 4 + 64 + 17 * 8)
        if total <= _SMEM_LIMIT or bufs == 1:
            return total, bufs


def smem_bytes(d: int, k: int) -> int:
    """Dynamic shared memory of one tensor-core-route block."""
    return tc_layout(d, k)[0]


def partition(m: int, n: int, sms: int) -> tuple:
    """(blocks, slabs, tiles) of the tensor-core route: the work units are
    (slab of 128 test rows, tile of 64 training rows), slabs x tiles of
    them in slab-major order, cut into ``blocks`` contiguous runs, one
    persistent block per SM (fewer where there are fewer units)."""
    slabs, tiles = -(-m // TC_ROWS), -(-n // TC_TILE)
    return min(sms, slabs * tiles), slabs, tiles


def run_of(b: int, blocks: int, units: int) -> tuple:
    """Units [u0, u1) of block b's run (as the kernel cuts them)."""
    return b * units // blocks, (b + 1) * units // blocks


def list_length(k: int) -> int:
    """The merge's register list length for ``k`` (8, 16 or 32)."""
    for kb in (8, 16, 32):
        if k <= kb:
            return kb
    raise ValueError(f"knn_topk kernel supports k <= {MAX_K}, got {k}")


def route(k: int, d: int) -> str:
    """The CUDA route for k neighbours in d dims: ``"tensor_cores"`` where
    the merge's register lists hold k and d is at most MAX_D (where that
    route is the faster), else ``"wide"`` (the depth-streamed route, any k and d)."""
    return "tensor_cores" if k <= MAX_K and d <= MAX_D else "wide"


def wide_smem(k: int) -> tuple:
    """(dynamic shared memory of one wide-route block, whether the rows'
    lists of k keys are in it): the ring and the buffers, plus the lists
    where all fit in one block (k <= 85), else the lists stay in global
    scratch.  No term depends on d."""
    with_lists = WIDE_RING_BYTES + WIDE_BUF_BYTES + WIDE_ROWS * k * 8
    if with_lists <= _SMEM_LIMIT:
        return with_lists, True
    return WIDE_RING_BYTES + WIDE_BUF_BYTES, False


def wide_partition(m: int, n: int, k: int, sms: int) -> tuple:
    """(splits, chunk) of the wide route: the training rows cut into
    ``splits`` contiguous chunks of ``chunk`` rows (whole tiles of 128),
    for the ceil(m / 128) x splits blocks (one per SM) to fill their last
    wave: the fewest splits within 2% of the best time, ceil(blocks /
    sms) / splits, at most WIDE_MAX_SPLITS, chunks of at least
    WIDE_MIN_TILES tiles (a split's first tiles fill its lists, at the
    cost of many merges), and the lists (splits x m x k keys) within
    WIDE_SCRATCH_KEYS unless one split alone is larger."""
    row_blocks = math.ceil(m / WIDE_ROWS)
    most = max(1, min(WIDE_MAX_SPLITS, n // (WIDE_MIN_TILES * WIDE_TILE),
                      WIDE_SCRATCH_KEYS // (m * k)))
    cost = {s: math.ceil(row_blocks * s / sms) / s for s in range(1, most + 1)}
    best = min(cost.values())
    splits = min(s for s, c in cost.items() if c <= 1.02 * best)
    chunk = math.ceil(math.ceil(n / splits) / WIDE_TILE) * WIDE_TILE
    return math.ceil(n / chunk), chunk


def knn_topk_cuda(test_x: torch.Tensor, train_x: torch.Tensor,
                  train_y: torch.Tensor, k: int):
    """Launch the CUDA kernels of :func:`route`'s choice.  test_x (m, d)
    and train_x (n, d) fp32, train_y (n,) int32, all contiguous on one
    CUDA device.  Returns (dists (m, k) fp32 ascending, labels (m, k)
    int32)."""
    _build.refuse_grad("knn_topk_cuda", test_x, train_x)
    _check_shapes(test_x, train_x, train_y, k)
    dev = _build.require("knn_topk_cuda", [("test_x", test_x, (torch.float32,)),
                                           ("train_x", train_x, (torch.float32,)),
                                           ("train_y", train_y, (torch.int32,))])
    (m, d), n = test_x.shape, train_x.shape[0]
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((m, k), dtype=torch.int32, device=dev)
    which = route(k, d)
    if which == "tensor_cores":
        blocks, slabs, tiles = partition(
            m, n, torch.cuda.get_device_properties(dev).multi_processor_count)
        # |x|^2, then |y|^2 padded to whole tiles and 16-byte aligned
        at = -(-m // 4) * 4
        sq = torch.empty((at + tiles * TC_TILE,), dtype=torch.float32, device=dev)
        part = torch.empty(((blocks + slabs - 1) * TC_ROWS * k,), dtype=torch.int64, device=dev)
        _build.launch("knn_topk", "knn_topk_launch", dev,
                      test_x.data_ptr(), train_x.data_ptr(), train_y.data_ptr(), m, n, d, k,
                      list_length(k), blocks, sq.data_ptr(), sq[at:].data_ptr(), part.data_ptr(),
                      out_d.data_ptr(), out_l.data_ptr(), route=which)
    else:
        smem, lists_shared = wide_smem(k)
        splits, chunk = wide_partition(
            m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        sq = torch.empty((m + n,), dtype=torch.float32, device=dev)
        part = torch.empty((splits, m, k), dtype=torch.int64, device=dev)
        tmp = torch.empty((2, m, k) if splits > 1 else (1,), dtype=torch.int64, device=dev)
        _build.launch("knn_topk", "knn_wide_launch", dev,
                      test_x.data_ptr(), train_x.data_ptr(), train_y.data_ptr(), m, n, d, k,
                      chunk, splits, _build.copy_width(d, test_x, train_x), int(lists_shared),
                      smem, sq.data_ptr(), sq[m:].data_ptr(), part.data_ptr(), tmp.data_ptr(),
                      out_d.data_ptr(), out_l.data_ptr(), route=which)
    return out_d, out_l
