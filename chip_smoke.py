#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; each prints one JSON line with its wall time, and any
failure raises (the script then exits non-zero without a result):

1. device  — name, compute capability (>= 9.0), nvidia-smi's name and
             power limit;
2. build   — nvcc builds the port's kernels from ``src/repro_torch/csrc``;
3. kernels — each hand-written kernel against its plain PyTorch version
             on the card: exactly on integer-valued inputs (ties
             included), within stated tolerances on random normal inputs
             at the pipelines' shapes and at ragged shapes, and bitwise
             equal across two launches; then timed;
4. knn     — run_knn on 2M x 50 training rows, 50k test rows;
5. kmeans  — run_kmeans on 8M x 50 points, k=16, 10 iterations, twice;
6. linreg  — run_linreg on 2M x 100 rows.

Then a ``{"kernels": [...]}`` line (launches counted during phases 4-5,
times measured in phase 3) and, last, ``{"ok": true, "device": {...}}``.
The script imports nothing of the JAX package; it needs one CUDA card
and the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12     # HBM3

SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class Phase:
    """Times one phase and prints its JSON line when it ends cleanly."""

    def __init__(self, name: str):
        self.name = name
        self.info: dict = {}

    def __enter__(self):
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            torch.cuda.synchronize()
            emit({"phase": self.name, "seconds": time.perf_counter() - self.t0,
                  **self.info})
        return False


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of CUDA-event-timed calls of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(least time in ms, what bounds it) on the published H100 peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def task_seconds(rt) -> dict:
    """Host seconds spent in each task type, summed over the workers.
    Kernels launch asynchronously: their device time lands in whichever
    later task waits on the card."""
    return {name: st["total"] for name, st in rt.tracer.task_duration_stats().items()}


def bitwise_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------------------ kernels
def check_knn(knn_k, gen, cuda):
    """knn_topk kernel vs its plain version; returns the kernels-line row."""
    def ints(shape):
        return torch.from_numpy(gen.integers(-3, 4, size=shape).astype(np.float32)).to(cuda)

    # integer-valued inputs: every distance is exact, and duplicated
    # training rows (with other labels) and test rows equal to training
    # rows make ties everywhere
    m, n, d = 300, 1000, 50
    train = ints((n, d))
    train[500:700] = train[0:200]
    test = ints((m, d))
    test[:50] = train[100:150]
    labels = torch.from_numpy(gen.integers(0, 4, size=n).astype(np.int32)).to(cuda)
    for k in (1, 5, 16, 32):
        got = knn_k.knn_topk_cuda(test, train, labels, k)
        want = knn_k.knn_topk_plain(test, train, labels, k)
        assert bitwise_equal(got, want), f"knn_topk integer case k={k} differs"

    def normal_case(m, n, d, k):
        test = torch.from_numpy(gen.standard_normal((m, d)).astype(np.float32)).to(cuda)
        train = torch.from_numpy(gen.standard_normal((n, d)).astype(np.float32)).to(cuda)
        labels = torch.from_numpy(gen.integers(0, 4, size=n).astype(np.int32)).to(cuda)
        got = knn_k.knn_topk_cuda(test, train, labels, k)
        again = knn_k.knn_topk_cuda(test, train, labels, k)
        assert bitwise_equal(got, again), "knn_topk: two launches differ"
        kk = min(k + 1, n)
        want_d, want_l = knn_k.knn_topk_plain(test, train, labels, kk)
        torch.testing.assert_close(got[0], want_d[:, :k], rtol=1e-5, atol=1e-3)
        # labels must agree wherever the order is not decided by a near-tie
        gap = want_d[:, 1:] - want_d[:, :-1]                     # (m, kk-1)
        sep = torch.ones((m, kk + 1), dtype=torch.bool, device=cuda)
        sep[:, 1:kk] = gap > 1e-3       # sep[:, i]: clear gap before position i
        isolated = sep[:, :k] & sep[:, 1:k + 1]
        assert torch.equal(got[1][isolated], want_l[:, :k][isolated]), \
            "knn_topk labels differ away from near-ties"
        return test, train, labels, (got[0] - want_d[:, :k]).abs().max().item()

    normal_case(1037, 10013, 50, 5)             # ragged m and n
    normal_case(129, 3, 50, 3)                  # k > fragment rows: the caller passes n
    normal_case(77, 5000, 13, 20)               # d not a multiple of 4, K=32 list
    # the path shape: one KNN_frag task of phase 4
    m, n, d, k = 12_500, 125_000, 50, 5
    test, train, labels, err = normal_case(m, n, d, k)
    ms = time_ms(lambda: knn_k.knn_topk_cuda(test, train, labels, k), reps=10)
    plain_ms = time_ms(lambda: knn_k.knn_topk_plain(test, train, labels, k), reps=3, warmup=1)
    bound_ms, bound_by = bound(2.0 * m * n * d, 4.0 * (m * d + n * d + n) + 8.0 * m * k)
    return {"name": "knn_topk", "route": "cuda",
            "source": "src/repro_torch/csrc/knn_topk.cu",
            "replaces": "src/repro/kernels/knn_topk.py:86",
            "shape": {"m": m, "n": n, "d": d, "k": k},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def check_kmeans(km_k, gen, cuda):
    """kmeans_assign kernel vs its plain version; returns the kernels-line row."""
    def ints(shape):
        return torch.from_numpy(gen.integers(-2, 3, size=shape).astype(np.float32)).to(cuda)

    # integer-valued inputs: dot products, |c|^2/2, sums and sse are exact;
    # half-integer scores make argmax ties common
    for n, d, k in ((5000, 50, 16), (1001, 13, 5)):
        x, c = ints((n, d)), ints((k, d))
        got = km_k.kmeans_assign_cuda(x, c)
        want = km_k.kmeans_assign_plain(x, c)
        assert bitwise_equal(got, want), f"kmeans_assign integer case {(n, d, k)} differs"

    def normal_case(n, d, k):
        x = torch.from_numpy(gen.standard_normal((n, d)).astype(np.float32)).to(cuda)
        c = torch.from_numpy(gen.standard_normal((k, d)).astype(np.float32)).to(cuda)
        # drop the points whose two best centroids score within 1e-4:
        # there the fp32 rounding of two dot-product orders may decide
        half = x @ c.T - 0.5 * (c * c).sum(1)[None, :]
        top2 = half.topk(2, dim=1).values
        x = x[(top2[:, 0] - top2[:, 1]) >= 1e-4].contiguous()
        got = km_k.kmeans_assign_cuda(x, c)
        again = km_k.kmeans_assign_cuda(x, c)
        assert bitwise_equal(got, again), "kmeans_assign: two launches differ"
        sums, counts, sse = km_k.kmeans_assign_plain(x, c)
        assert torch.equal(got[1], counts), "kmeans_assign counts differ"
        torch.testing.assert_close(got[0], sums, rtol=1e-5,
                                   atol=1e-5 * sums.abs().max().item())
        torch.testing.assert_close(got[2], sse, rtol=1e-5, atol=0.0)
        return x, c, (got[0] - sums).abs().max().item()

    normal_case(1007, 13, 5)                    # ragged tile, k not a multiple of 4
    normal_case(100_003, 50, 16)
    # the path shape: one partial_sum task of phase 5
    n, d, k = 500_000, 50, 16
    x, c, err = normal_case(n, d, k)
    n = x.shape[0]
    ms = time_ms(lambda: km_k.kmeans_assign_cuda(x, c), reps=20)
    plain_ms = time_ms(lambda: km_k.kmeans_assign_plain(x, c), reps=10)
    bound_ms, bound_by = bound(2.0 * n * k * d + 3.0 * n * d,
                               4.0 * (n * d + 2 * k * d + k + 1))
    return {"name": "kmeans_assign", "route": "cuda",
            "source": "src/repro_torch/csrc/kmeans_assign.cu",
            "replaces": "src/repro/kernels/kmeans_assign.py:65",
            "shape": {"n": n, "d": d, "k": k},
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ----------------------------------------------------------------- pipelines
def knn_oracle_agreement(knn, knn_k, make_blobs, preds, cuda, *, n_train, n_test,
                         d, k, n_classes, train_fragments, test_blocks, rows=1000):
    """Predictions of ``rows`` random test rows recomputed against the
    whole training set with the plain top-k in float64 on the card."""
    frag_n = [n_train // train_fragments] * train_fragments
    frag_n[-1] += n_train - sum(frag_n)
    parts = [make_blobs(SEED + i, frag_n[i], d, n_classes) for i in range(train_fragments)]
    X = torch.from_numpy(np.concatenate([p[0] for p in parts])).to(cuda)
    y = torch.from_numpy(np.concatenate([p[1] for p in parts]).astype(np.int32)).to(cuda)
    blk_n = [n_test // test_blocks] * test_blocks
    blk_n[-1] += n_test - sum(blk_n)
    tests = np.concatenate([make_blobs(10_000 + SEED + b, blk_n[b], d, n_classes)[0]
                            for b in range(test_blocks)])
    idx = np.sort(np.random.default_rng(1).choice(n_test, size=rows, replace=False))
    sel = torch.from_numpy(tests[idx]).to(cuda)
    top = knn_k.knn_topk_plain(sel, X, y, k, block_n=65536)
    want = knn.knn_classify(top, n_classes).cpu().numpy()
    return int((want == preds[idx]).sum())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; one CUDA card is needed",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.algorithms import kmeans, knn, linreg
    from repro_torch.algorithms.common import make_blobs
    from repro_torch.core import api
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import kmeans_assign as km_k
    from repro_torch.kernels import knn_topk as knn_k

    # full fp32 products in every plain version and reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device("cuda", 0)
    gen = np.random.default_rng(SEED)

    with Phase("device") as ph:
        name = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        assert cap >= (9, 0), f"{name} has compute capability {cap}; sm_90a needs (9, 0)"
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
        print(smi, flush=True)
        ph.info.update(name=name, capability=list(cap), nvidia_smi=smi,
                       torch=torch.__version__, cuda=torch.version.cuda,
                       sms=torch.cuda.get_device_properties(0).multi_processor_count)

    with Phase("build") as ph:
        _build.library()
        ph.info.update(build_seconds=_build.build_seconds, ptxas=[
            line.strip() for line in _build.build_log.splitlines()
            if "Compiling entry" in line or "Used" in line or "spill" in line])

    with Phase("kernels") as ph:
        rows = [check_knn(knn_k, gen, cuda), check_kmeans(km_k, gen, cuda)]
        ph.info["kernels"] = [{k: r[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                                 "bound_ms")} for r in rows]

    launches = {}
    knn_cfg = dict(n_train=2_000_000, n_test=50_000, d=50, k=5, n_classes=4,
                   train_fragments=16, test_blocks=4)
    with Phase("knn") as ph:
        ops.reset_launch_counts()
        with api.runtime_start(n_workers=4, backend="thread") as rt:
            res = knn.run_knn(**knn_cfg, seed=SEED, device=cuda)
        ph.info["pipeline_seconds"] = rt.tracer.wallclock()
        ph.info["task_seconds"] = task_seconds(rt)
        counts = ops.launch_counts()
        launches["knn_topk"] = counts["knn_topk"]
        assert counts == {"knn_topk": 64, "kmeans_assign": 0}, counts
        preds = res.predictions
        assert preds.shape == (50_000,) and preds.min() >= 0 and preds.max() < 4
        agree = knn_oracle_agreement(knn, knn_k, make_blobs, preds, cuda, **knn_cfg)
        assert agree >= 999, f"only {agree}/1000 predictions agree with the fp64 oracle"
        ph.info.update(tasks=res.n_tasks, launches=counts, oracle_agree=agree)

    with Phase("kmeans") as ph:
        cfg = dict(n_points=8_000_000, d=50, k=16, fragments=16, max_iters=10, tol=0.0,
                   seed=SEED, device=cuda)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with api.runtime_start(n_workers=4, backend="thread") as rt:
            r1 = kmeans.run_kmeans(**cfg)
        t_first = time.perf_counter() - t0
        ph.info["task_seconds"] = task_seconds(rt)
        counts = ops.launch_counts()
        launches["kmeans_assign"] = counts["kmeans_assign"]
        assert counts == {"knn_topk": 0, "kmeans_assign": 160}, counts
        assert r1.centroids.shape == (16, 50) and np.isfinite(r1.centroids).all()
        hist = r1.sse_history
        assert len(hist) == 10 and all(np.isfinite(hist))
        for a, b in zip(hist, hist[1:]):
            assert b <= a * (1 + 1e-6), f"SSE rose from {a} to {b}"
        with api.runtime_start(n_workers=4, backend="thread"):
            r2 = kmeans.run_kmeans(**cfg)
        assert r1.centroids.tobytes() == r2.centroids.tobytes(), \
            "two K-means runs gave different centroids"
        ph.info.update(first_run_seconds=t_first, sse_history=hist, shifts=r1.shifts)

    with Phase("linreg") as ph:
        n_rows, p, fragments = 2_000_000, 100, 16
        ops.reset_launch_counts()
        with api.runtime_start(n_workers=4, backend="thread") as rt:
            r = linreg.run_linreg(n_rows=n_rows, p=p, n_pred=100_000, fragments=fragments,
                                  pred_blocks=4, seed=SEED, device=cuda)
        assert ops.launch_counts() == {"knn_topk": 0, "kmeans_assign": 0}
        ph.info["pipeline_seconds"] = rt.tracer.wallclock()
        ph.info["task_seconds"] = task_seconds(rt)
        assert r.predictions.shape == (100_000,) and np.isfinite(r.predictions).all()
        truth = np.random.default_rng(1234).standard_normal(p + 1)
        err_truth = float(np.abs(r.beta - truth).max())
        assert err_truth <= 1e-2, f"beta is {err_truth} from the ground truth"
        # single-shot float64 solve over all rows on the card
        frag_n = [n_rows // fragments] * fragments
        frag_n[-1] += n_rows - sum(frag_n)
        parts = [linreg.lr_fill_fragment(SEED + i, frag_n[i], p, device=cuda)
                 for i in range(fragments)]
        whole = (torch.cat([q[0] for q in parts]), torch.cat([q[1] for q in parts]))
        del parts
        beta1 = linreg.compute_model_parameters(linreg.partial_ztz(whole),
                                                linreg.partial_zty(whole)).cpu().numpy()
        err_single = float(np.abs(r.beta - beta1).max())
        assert err_single <= 1e-8, f"beta is {err_single} from the single-shot solve"
        ph.info.update(tasks=r.n_tasks, beta_vs_truth=err_truth, beta_vs_single_shot=err_single)

    for row in rows:
        row["launches"] = launches[row["name"]]
    emit({"kernels": [{k: row[k] for k in ("name", "route", "source", "replaces", "launches",
                                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms", "shape")}
                      for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
