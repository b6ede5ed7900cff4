#!/usr/bin/env python3
"""Knock-out probes of the wide CUDA routes of ``knn_topk`` and
``kmeans_assign``: what each part of a kernel costs on the card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_knockout.py

Each variant is a copy of ``src/repro_torch/csrc`` with one part of the
wide kernels removed by a text substitution (``VARIANTS``): the 3xTF32
products, the slice copies after the ring's first fill, two of the three
TF32 products, the merges of buffered keys into the lists (knn), the
sort and the sums (kmeans).  Every copy is built with ``nvcc`` into its
own library under the git-ignored ``build/ko/`` and its wrappers are
timed with ``chip_smoke.device_ms`` beside the unchanged source
(``base``, first and last) at the wide shapes ``chip_smoke.py`` times.
A knocked-out variant's results are wrong; only its time is read.  The
times print as JSON lines and land in ``build/ko/knockout.json``.

    python3 chip_knockout.py --crossover

times instead both routes of ``knn_topk`` from the unchanged source at
m 12,500, n 125,000 and k 5 and 32, over depths from 48 to 80 around the
route edge: the route is forced by replacing ``knn_topk.route``.  The
tensor-core route is built for d <= 64 (its test rows' fragments stay in
registers), so past 64 only the wide route is timed.  The times land in
``build/ko/crossover.json``; ``knn_topk.MAX_D`` is set from them.
"""
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import kmeans_assign as km_k  # noqa: E402
from repro_torch.kernels import knn_topk as knn_k  # noqa: E402

K, M, C = "knn_topk.cu", "kmeans_assign.cu", "common.cuh"
LOAD = "    if (s + kWideStages - 1 < steps) issue(s + kWideStages - 1);"
# with no merge the lists stay empty: decode no label
NOLAB = "labels[static_cast<uint32_t>(key)]"
NOLAB_FIX = "(key == kNone ? 0 : labels[static_cast<uint32_t>(key)])"
# the kmeans sums; then also its sort (the bitonic runs and their merge)
SUMS = ("for (int item = tid; item < ns * 32; item += kThreads) {",
        "for (int item = tid; item < 0; item += kThreads) {")
VARIANTS = {
    "base": {},
    "ko_flush": {K: [("  auto flush = [&]() {\n", "  auto flush = [&]() {\n    cnt_lo = cnt_hi = 0;\n    return;\n"),
                     (NOLAB, NOLAB_FIX)]},
    "ko_mma": {K: [("    repro::mma_slice_3xtf32<16, false>(acc, st + a_off, st + b_off, ksteps, 16, unused);", "")],
               M: [("    const int nt_active = (min(PW, k - c0) + 15) / 16 * 2;",
                    "    const int nt_active = 0;")]},
    "ko_load": {K: [(LOAD, "")], M: [(LOAD, "")]},
    "ko_1x": {C: [("  mma_tf32(step, al, bh0, bh1);\n  mma_tf32(step, ah, bl0, bl1);\n", "")]},
    "ko_sums": {M: [SUMS]},
    "ko_sort": {M: [SUMS, ("      for (int size = 2; size <= 32; size <<= 1) {",
                           "      for (int size = 64; size <= 32; size <<= 1) {"),
                    ("if (o != warp) place += count_below(", "if (o != warp) place += 0 * count_below(")]},
}
OUT = ROOT / "build" / "ko"


def build_all():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    jobs = []
    for name, patches in VARIANTS.items():
        d = OUT / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        for fname, subs in patches.items():
            text = (d / fname).read_text()
            for old, new in subs:
                assert old in text, (name, fname, old[:60])
                text = text.replace(old, new)
            (d / fname).write_text(text)
        for src in ("knn_topk.cu", "kmeans_assign.cu", "errors.cu"):
            cmd = [nvcc, *_build.NVCC_FLAGS, "-c", str(d / src), "-o", str(d / (src + ".o"))]
            jobs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    for name, p in jobs:
        out, _ = p.communicate()
        assert p.returncode == 0, (name, out)
    libs = {}
    for name in VARIANTS:
        d = OUT / name
        so = d / "lib.so"
        subprocess.run([nvcc, *_build.ARCH_FLAGS, "-shared", "-o", str(so),
                        *(str(d / (s + ".o")) for s in ("knn_topk.cu", "kmeans_assign.cu",
                                                         "errors.cu"))], check=True)
        lib = ctypes.CDLL(str(so))
        for fn in ("knn_topk_launch", "kmeans_assign_launch", "kmeans_wide_launch",
                   "knn_wide_launch", "repro_cuda_error_string"):
            argtypes, restype = _build.SIGNATURES[fn]
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        libs[name] = lib
    return libs


def crossover(cuda):
    """Device ms of both knn routes, each forced, around the route edge."""
    res = []
    chosen = knn_k.route
    for k in (5, 32):
        for d in (48, 56, 64, 72, 80):
            te = torch.randn((12_500, d), device=cuda)
            tr = torch.randn((125_000, d), device=cuda)
            lab = torch.randint(0, 4, (125_000,), device=cuda, dtype=torch.int32)
            row = {"d": d, "k": k}
            routes = ("tensor_cores", "wide") if d <= knn_k.MAX_D else ("wide",)
            for r in routes * 2:
                knn_k.route = lambda k, d, r=r: r
                row.setdefault(r, []).append(
                    cs.device_ms(lambda: knn_k.knn_topk_cuda(te, tr, lab, k), reps=5))
            knn_k.route = chosen
            res.append(row)
            print(json.dumps(row), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "crossover.json").write_text(json.dumps(res, indent=1))


def main():
    cuda = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    if "--crossover" in sys.argv[1:]:
        crossover(cuda)
        return
    libs = build_all()
    print("built", list(libs), flush=True)
    res = {}
    knn_shapes = [(12_500, 125_000, 50, 33), (12_500, 125_000, 300, 5),
                  (12_500, 125_000, 273, 5), (5000, 31_250, 384, 50)]
    km_shapes = [(500_000, 50, 65), (100_000, 257, 16), (62_500, 384, 100)]
    order = ["base"] + [v for v in VARIANTS if v != "base"] + ["base"]
    for (m, n, d, k) in knn_shapes:
        te, tr = torch.randn((m, d), device=cuda), torch.randn((n, d), device=cuda)
        lab = torch.randint(0, 4, (n,), device=cuda, dtype=torch.int32)
        row = {}
        for v in order:
            if v in ("ko_sums", "ko_sort"):
                continue
            _build._lib = libs[v]
            row.setdefault(v, []).append(cs.device_ms(lambda: knn_k.knn_topk_cuda(te, tr, lab, k),
                                                      reps=5))
        res[f"knn {m}x{n}x{d} k{k}"] = row
        print(json.dumps({f"knn {m}x{n}x{d} k{k}": row}), flush=True)
    for (n, d, k) in km_shapes:
        x, c = torch.randn((n, d), device=cuda), torch.randn((k, d), device=cuda)
        row = {}
        for v in order:
            if v == "ko_flush":
                continue
            _build._lib = libs[v]
            row.setdefault(v, []).append(cs.device_ms(lambda: km_k.kmeans_assign_cuda(x, c),
                                                      reps=20))
        res[f"km {n}x{d} k{k}"] = row
        print(json.dumps({f"km {n}x{d} k{k}": row}), flush=True)
    (OUT / "knockout.json").write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
