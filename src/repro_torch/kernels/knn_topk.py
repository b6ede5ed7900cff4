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
* :func:`knn_topk_cuda` — the hand-written CUDA kernel
  (``csrc/knn_topk.cu``, which documents its design and bound): the cross
  term on the tensor cores in 3xTF32 (fp32-grade), the top-k walked per
  test row in training-index order — for k <= 32 and d <= 64 (it holds
  d up to 272, but past 64 the wide route is faster).  Every other k
  and d take the wide route: the same 3xTF32 product with both
  operands streamed in 32-deep slices (shared memory independent of d),
  each test row's k best kept as 64-bit keys (distance, index), which
  keep the tie rule, behind a threshold in a register.  :func:`route`
  picks one by shape before launch, and a route that fails raises:
  neither hands work to the other or to the plain version.  It takes
  only contiguous fp32 CUDA tensors and raises on anything else.

:func:`repro_torch.kernels.ops.knn_topk` picks one by device.
"""
from __future__ import annotations

import math
import threading

import torch

from . import _build

BIG = 1e30
MAX_K = 32             # register list lengths the kernel is built for: 8/16/32
# the tensor-core route's depth: past 64 a block's rows take 76 floats, an
# SM holds one block fewer, and the wide route is faster at k 5 and 32
# (d 72: 6.90 / 9.63 ms against 7.35 / 9.65; d 64: 5.76 / 8.40-8.64
# against 4.62 / 6.72-7.01; ``chip_knockout.py --crossover``)
MAX_D = 64
_BLOCK_ROWS = 128      # test rows per CUDA block (kBlockRows in csrc/knn_topk.cu)
_TILE = 32             # training rows per shared tile (kTile there)
_CROSS_FLOATS = 4 * _TILE * 36   # the four warps' cross-term tiles (kLDC = 36)
_SMEM_LIMIT = 232448   # dynamic shared memory a Hopper block may use
_SMEM_PER_SM = 233472  # shared memory of one SM
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

launches = 0         # kernel launches since the last reset (plain int)
_count_lock = threading.Lock()


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


def tile_ld(d: int) -> int:
    """Shared row stride, in floats, of the kernel's tiles: mirrors
    ``tile_ld`` in ``csrc/knn_topk.cu`` (d rounded up to 8, plus 4)."""
    return -(-d // 8) * 8 + 4


def smem_bytes(d: int) -> int:
    """Dynamic shared memory of one kernel block (see the .cu source): the
    test rows, two training tiles, the cross-term tiles, labels and norms."""
    return ((_BLOCK_ROWS + 2 * _TILE) * tile_ld(d) + _CROSS_FLOATS) * 4 + 2 * _TILE * 8


def partition(m: int, n: int, d: int, sms: int) -> tuple:
    """(splits, chunk): the training rows cut into ``splits`` contiguous
    chunks of ``chunk`` rows (whole tiles; the last may be short), so that
    the ceil(m / 128) x splits blocks fill one wave of resident blocks on
    ``sms`` SMs."""
    wave = (_SMEM_PER_SM // (smem_bytes(d) + 1024)) * sms
    row_blocks = math.ceil(m / _BLOCK_ROWS)
    splits = max(1, min(wave // row_blocks, math.ceil(n / _TILE)))
    chunk = math.ceil(math.ceil(n / splits) / _TILE) * _TILE
    return math.ceil(n / chunk), chunk


def list_length(k: int) -> int:
    """The kernel's register list length for ``k`` (8, 16 or 32)."""
    for kb in (8, 16, 32):
        if k <= kb:
            return kb
    raise ValueError(f"knn_topk kernel supports k <= {MAX_K}, got {k}")


def route(k: int, d: int) -> str:
    """The CUDA route for k neighbours in d dims: ``"tensor_cores"`` where
    the register lists hold k and d is at most MAX_D (where that route is
    the faster), else ``"wide"`` (the depth-streamed route, any k and d)."""
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
    global launches
    _build.refuse_grad("knn_topk_cuda", test_x, train_x)
    _check_shapes(test_x, train_x, train_y, k)
    dev = test_x.device
    for name, t, dt in (("test_x", test_x, torch.float32),
                        ("train_x", train_x, torch.float32),
                        ("train_y", train_y, torch.int32)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"knn_topk_cuda: {name} is on {t.device}, expected one CUDA device")
        if t.dtype != dt:
            raise TypeError(f"knn_topk_cuda: {name} is {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"knn_topk_cuda: {name} must be contiguous")
    (m, d), n = test_x.shape, train_x.shape[0]
    out_d = torch.empty((m, k), dtype=torch.float32, device=dev)
    out_l = torch.empty((m, k), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.library()
    if route(k, d) == "tensor_cores":
        kb = list_length(k)
        splits, chunk = partition(m, n, d,
                                  torch.cuda.get_device_properties(dev).multi_processor_count)
        train_sq = torch.empty((n,), dtype=torch.float32, device=dev)
        part_d = torch.empty((splits, m, kb), dtype=torch.float32, device=dev)
        part_l = torch.empty((splits, m, kb), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.knn_topk_launch(
                test_x.data_ptr(), train_x.data_ptr(), train_y.data_ptr(),
                m, n, d, k, kb, chunk, splits, train_sq.data_ptr(),
                part_d.data_ptr(), part_l.data_ptr(), out_d.data_ptr(), out_l.data_ptr(), stream)
    else:
        smem, lists_shared = wide_smem(k)
        splits, chunk = wide_partition(
            m, n, k, torch.cuda.get_device_properties(dev).multi_processor_count)
        sq = torch.empty((m + n,), dtype=torch.float32, device=dev)
        part = torch.empty((splits, m, k), dtype=torch.int64, device=dev)
        tmp = torch.empty((2, m, k) if splits > 1 else (1,), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            err = lib.knn_wide_launch(
                test_x.data_ptr(), train_x.data_ptr(), train_y.data_ptr(), m, n, d, k, chunk,
                splits, _build.copy_width(d, test_x, train_x), int(lists_shared), smem,
                sq.data_ptr(), sq[m:].data_ptr(), part.data_ptr(), tmp.data_ptr(),
                out_d.data_ptr(), out_l.data_ptr(), stream)
    _build.check(err, "knn_topk")
    with _count_lock:
        launches += 1
    return out_d, out_l
