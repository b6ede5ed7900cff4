#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``--parent DIR`` also times the kernels of another checkout of the
repository (for example ``git archive`` of the parent commit unpacked
into ``build/parent``) beside this one's, in the same process on the same
inputs, for ``kmeans_assign``, bf16 ``ssd_scan`` and ``rmsnorm`` (every
timed shape): their rows then carry ``parent_ms``, read before and after
this checkout's kernel.

Phases, in order; each prints one JSON line with its wall time, and any
failure raises (the script then exits non-zero without a result):

1. device  — name, compute capability (>= 9.0), nvidia-smi's name and
             power limit;
2. build   — nvcc builds the port's kernels from ``src/repro_torch/csrc``;
             the toolkit's ``cuobjdump -sass`` counts the tensor-core
             instructions (HMMA / HGMMA) of every tensor-core kernel (bf16
             flash at every head dim, the knn tile kernel, the kmeans
             partials kernel and the bf16 SSD chunk kernel at every
             template), which must be non-zero, and ptxas must report 0
             spill bytes for them; every one-pass ``rmsnorm`` instance
             must keep its packs in registers (no spill, no stack frame);
3. kernels — each hand-written kernel against its plain PyTorch version
             on the card: exactly on integer-valued inputs (ties
             included), within stated tolerances on random normal inputs
             at the main paths' shapes and at ragged shapes, and bitwise
             equal across two launches; then timed beside its bound, its
             plain version and (where one exists) the one PyTorch call
             that computes the same function.  ``kmeans_assign`` and
             ``knn_topk`` are also checked and timed at shapes past their
             tensor-core routes (their rows' ``wide_shapes``: the wide
             CUDA routes), and each row names the route it took;
4. knn     — run_knn on 2M x 50 training rows, 50k test rows;
5. kmeans  — run_kmeans on 8M x 50 points, k=16, 10 iterations, twice;
6. linreg  — run_linreg on 2M x 100 rows;
7. serve   — serve_batch on qwen3-0.6b at full width (28 layers, d 1024,
             bf16, random weights from seed 0): 8 prompts of 512 tokens,
             32 generated tokens each, twice; then one cache-free forward
             over prompt + generated tokens, held against the served
             logits (replayed) and against two controls;
8. serve_ssd    — the same on mamba2-780m at full width (48 SSD layers,
             d 1536, 48 heads x 64, state 128, bf16), one control;
9. serve_hybrid — the same on recurrentgemma-9b at full width (38 layers =
             12 x (rglru, rglru, local_attn) + 2 rglru, d 4096, MQA with
             head dim 256, window 2048, bf16, 9.6B parameters), one control;
10. serve_moe — the same on deepseek-moe-16b at full width (28 layers,
             d 2048, MHA 16 x 128, 64 routed experts of width 1408, top-6,
             2 shared, vocab 102,400, bf16, 16.9B parameters), one
             control; the full-forward comparison and its control run at
             the no-drop capacity factor E / k, on the same weights (the
             served path's capacity comes from each call's token count,
             so prefill, decode and one full forward drop differently);
             the share of choices of experts the two paths make apart is
             held, and the logits with the replay's routing forced on the
             full forward; the share
             of assignments dropped in the served prefill and decode is
             recorded;
11. train_parity — ``train_loop`` on the reduced qwen3, mamba2,
             recurrentgemma, deepseek-moe and qwen3-moe configs (fp32), 4
             steps on the card and on the CPU from the same
             ``init_params`` weights and batches: the losses agree within
             1e-4, the MoE balance loss is finite and nonzero; a
             checkpoint saved at step 2 by the runtime's
             ``checkpoint_save`` task restores into a fresh model on the
             card, which continues as the uninterrupted run did;
12. train  — ``train_loop`` on qwen3-0.6b at full width (bf16, remat
             "full"), batch 8 x 512 tokens, 10 steps: finite losses, the
             first within 1.0 of ln(vocab), exact launch counts, the loss
             on the first batch lower after the ten steps; one more step
             must lower the loss on its batch, and one under the profiler
             gives the device's idle share;
13. train_ssd — the same on mamba2-780m at full width;
14. train_moe — the same on deepseek-moe-16b at full width, its depth cut
             to 4 of 28 layers (at full depth, bf16 weights and gradients
             and fp32 moments need ~200 GB).

Phase 3 also holds the gradients through each model kernel's autograd
Function (the kernel's forward, the plain version's backward) against
autograd through the plain version.  Each serve and train phase frees its
model before the next.  Then a ``{"kernels": [...]}`` line (launches
counted during phases 4, 5 and 7-14, by phase; times measured in phase 3)
and, last, ``{"ok": true, "device": {...}}``.
The script imports nothing of the JAX package; it needs one CUDA card
and the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12       # bf16 on the tensor cores
PEAK_TF32_FLOPS = 495e12       # TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12     # HBM3
BF16_STEP = 2.0 ** -7          # one bf16 rounding step, relative

SEED = 0
# served vs full-forward logits, per served model (phases 7-10): logits
# are rounded to bf16 and the two paths (prefill + decode, one cache-free
# forward) round differently in every layer.  Each limit sits between the
# sound reading and a decode fed the wrong tokens (the lagged control,
# which each phase reads too); the readings are in PERF.md.  Sound and
# lagged readings on one H100: qwen3-0.6b 0.056 and 2.5, mamba2-780m 0.18
# and 6.1, recurrentgemma-9b 0.29 and 9.8, deepseek-moe-16b 0.117 and
# 4.59.  In deepseek (both sides at the no-drop capacity) a rounding apart
# flips near-ties among some of the MoE layers' top-6 choices, and a token
# routed apart mixes other experts (the free forward's logits read 1.04):
# the share of the generated positions' choices made apart is held to
# MAX_ROUTED_APART, between its sound and lagged readings (0.203 and
# 0.946), and the logits with the replay's routing forced on the full
# forward.
LOGIT_TOL = {"qwen3-0.6b": 0.08, "mamba2-780m": 0.25, "recurrentgemma-9b": 0.4,
             "deepseek-moe-16b": 0.16}
MAX_ROUTED_APART = 0.3
MOE_TRAIN_LAYERS = 4                        # phase train_moe: deepseek's depth cut
BATCH, PROMPT_LEN, GEN_LEN = 8, 512, 32    # every serve phase; train: BATCH x PROMPT_LEN
TRAIN_STEPS = 10                            # phases train and train_ssd
# phase train_parity: the reduced fp32 configs, card against CPU
PARITY = dict(steps=4, batch=4, seq=32, lr=1e-3, warmup=2, seed=SEED, workers=2, log_every=0)
PARITY_RTOL = 1e-4


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


class NoDeviceActivity(RuntimeError):
    """The profiler recorded no CUDA activity in a window."""


def device_kernels(fn):
    """(fn's result, {kernel: [device ms, launches]}) of one call of ``fn``,
    from torch.profiler's CUDA activity.  Raises where the profiler sees
    no device activity: a host clock is no stand-in for device time (for
    a kernel of a few microseconds it reads the wrapper's host cost)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    table = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            table[e.key] = [us / 1e3, e.count]
    if not table:
        raise NoDeviceActivity("torch.profiler saw no device activity")
    return out, table


SPIN = "spin_kernel"   # torch.cuda._sleep's kernel: the edges of a timed window
L2_BYTES = 50 * 2 ** 20  # the H100 SXM's L2
FLUSH = "bitwise_not"    # the kernel that evicts L2 before each call of a cold window


def device_ms(fn, reps: int, warmup: int = 2, tries: int = 5, cold: bool = False) -> float:
    """Device time of one call of ``fn``: every kernel it launches, summed,
    averaged over ``reps`` calls after ``warmup`` calls.  Every call
    launches the same kernels, so each kernel's event count must be a
    multiple of ``reps``; where it is not, or the window holds no device
    activity at all, the profiler lost events (both seen on the H100: a
    5 us kernel read 0.9 us, SDPA above the card's peak, an SDPA window
    empty, an ``ssd_scan`` window short of 8 of 20 events three times
    running), and the window is profiled again, up to ``tries`` times.  A
    short spin kernel opens and closes each window and is not counted:
    in windows of ~40 us of `F.rms_norm` the profiler lost one of 20
    events three times running.  ``cold``: each call follows a pass over
    a buffer of 4 x L2 that evicts its inputs from L2 (not counted), so a
    call reads them from DRAM, as its bytes bound assumes."""
    flush = torch.empty(4 * L2_BYTES, dtype=torch.uint8, device="cuda").bitwise_not_ \
        if cold else (lambda: None)

    def window():
        torch.cuda._sleep(1000)
        out = []
        for _ in range(reps):
            flush()
            out.append(fn())
        torch.cuda._sleep(1000)
        return out

    for _ in range(warmup):
        fn()
    table = {}
    for _ in range(tries):
        try:
            _, table = device_kernels(window)
        except NoDeviceActivity:
            continue
        table = {key: v for key, v in table.items()
                 if SPIN not in key and not (cold and FLUSH in key)}
        if table and all(n % reps == 0 for _, n in table.values()):
            return sum(ms for ms, _ in table.values()) / reps
        print(f"chip_smoke: the profiler lost events, profiling again: "
              f"{ {key[:60]: n for key, (_, n) in table.items()} }", file=sys.stderr)
    raise RuntimeError(f"torch.profiler lost events in {tries} windows of {reps} calls: "
                       f"{ {key[:60]: n for key, (_, n) in table.items()} }")


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FP32_FLOPS):
    """(least time in ms, what bounds it) on the published H100 peaks."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def time_library(name: str, *args, cold: bool = False) -> float:
    """Device ms of the one PyTorch call that computes a kernel's function,
    as its yardstick (``library_ms``); the port never calls these."""
    F = torch.nn.functional
    if name == "rmsnorm":
        x, scale, eps = args
        return device_ms(lambda: F.rms_norm(x, (x.shape[-1],), weight=scale, eps=eps),
                         reps=50 if cold else 20, cold=cold)
    q, k, v = args
    return device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                            enable_gqa=True), reps=20)


PARENT = {}    # kernel name -> its wrapper module in the --parent checkout


def load_parent(root: str) -> dict:
    """The kernel modules of the port in another checkout at ``root``,
    imported as the package ``parent_repro_torch``; their kernels build
    into ``root/build/repro_torch``."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "src", "repro_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_repro_torch", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_repro_torch"] = mod
    spec.loader.exec_module(mod)
    return {name: importlib.import_module(f"parent_repro_torch.kernels.{name}")
            for name in ("kmeans_assign", "ssd_scan", "rmsnorm")}


def with_parent(name: str, call, t_new) -> dict:
    """``t_new()`` (the kernels-line times of this checkout's kernel) and,
    with ``--parent``, the parent's kernel ``call(module)`` timed before
    and after it: parent, this, parent."""
    if name not in PARENT:
        return t_new()
    before = device_ms(lambda: call(PARENT[name]), reps=20)
    t = t_new()
    return {**t, "parent_ms": [before, device_ms(lambda: call(PARENT[name]), reps=20)]}


def times(kernel, plain, library_ms=None, reps: int = 20, plain_reps: int = 10) -> dict:
    """The kernels-line times of one kernel, all device ms: ``ms``,
    ``plain_ms`` and ``library_ms``."""
    return {"ms": device_ms(kernel, reps), "plain_ms": device_ms(plain, plain_reps, warmup=1),
            "library_ms": library_ms}


def task_seconds(rt) -> dict:
    """Host seconds spent in each task type, summed over the workers.
    Kernels launch asynchronously: their device time lands in whichever
    later task waits on the card."""
    return {name: st["total"] for name, st in rt.tracer.task_duration_stats().items()}


def ptxas_report(log: str) -> dict:
    """{function: {"registers", "spill_stores", "spill_loads", "stack"}}
    from the ``-Xptxas -v`` lines of the build log."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
        if m:
            fn = m.group(1)
            report.setdefault(fn, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            report[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn:
            report[fn]["stack"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
    return report


def tensor_core_counts(lib_path: str) -> dict:
    """{function: its HMMA / HGMMA instructions} in the built library's
    SASS, from the toolkit's ``cuobjdump -sass``."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : ([\w$]+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bHG?MMA\b", line):
            counts[fn] += 1
    return counts


# the redesigned tensor-core kernels: (name in the report, pattern of the
# mangled name); each must hold tensor-core instructions and spill nothing
TENSOR_CORE_KERNELS = [(f"flash_fwd_bf16_tc<{d}>", rf"flash_fwd_bf16_tcILi{d}E")
                       for d in (16, 32, 64, 128, 256)] + \
                      [(f"knn_chunk_topk<{kb}>", rf"knn_chunk_topkILi{kb}E")
                       for kb in (8, 16, 32)] + \
                      [(f"kmeans_tc_partials<{mt},{ntw}>", rf"kmeans_tc_partialsILi{mt}ELi{ntw}E")
                       for mt in (1, 2, 4) for ntw in (1, 2, 4)] + \
                      [(f"ssd_chunk_bf16_tc<{nk},{int(al)}>",
                        rf"ssd_chunk_bf16_tcILi{nk}ELb{int(al)}E")
                       for nk in (1, 2, 4, 8) for al in (True, False)]


def check_tensor_core_build(log: str, lib_path: str) -> dict:
    """Per redesigned kernel: its HMMA/HGMMA count, registers and spill
    bytes; raises where a count is 0 or a spill is not."""
    counts, ptxas = tensor_core_counts(lib_path), ptxas_report(log)
    out = {}
    for name, pattern in TENSOR_CORE_KERNELS:
        fns = [f for f in counts if re.search(pattern, f)]
        assert len(fns) == 1, f"{name}: {len(fns)} functions in the SASS match {pattern}"
        info = ptxas.get(fns[0], {})
        out[name] = {"mma": counts[fns[0]], **info}
        assert counts[fns[0]] > 0, f"{name} holds no tensor-core instruction"
        assert info.get("spill_stores") == 0 and info.get("spill_loads") == 0, \
            f"{name} spills: {info}"
    return out


def check_rmsnorm_build(log: str) -> dict:
    """Per one-pass ``rmsnorm`` instance (``rmsnorm_rows<TX, TS, lanes per
    row, packs per lane>``): registers, spill bytes and stack frame; raises
    where one spills or keeps a stack frame: its packs must stay in
    registers."""
    out = {}
    for fn, info in ptxas_report(log).items():
        m = re.search(r"rmsnorm_rowsI(\w+?)Li(\d+)ELi(\d+)E", fn)
        if not m:
            continue
        # x's and scale's types: f is float; any other (named, or a
        # substitution S.._ of it) is __nv_bfloat16
        types = ["fp32" if t == "f" else "bf16"
                 for t in re.findall(r"13__nv_bfloat16|S\d*_|f", m.group(1))]
        out[f"rmsnorm_rows<{','.join(types)},{m.group(2)},{m.group(3)}>"] = info
    assert len(out) == 40, f"{len(out)} one-pass rmsnorm instances in the build log"
    leaks = {name: info for name, info in out.items()
             if (info.get("spill_stores"), info.get("spill_loads"), info.get("stack")) != (0, 0, 0)}
    assert not leaks, f"rmsnorm instances leave their registers: {leaks}"
    return out


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
    # k past the register lists: the wide route, ties and all
    for k in (1, 5, 16, 32, 33, 100, 257):
        got = knn_k.knn_topk_cuda(test, train, labels, k)
        want = knn_k.knn_topk_plain(test, train, labels, k)
        assert bitwise_equal(got, want), f"knn_topk integer case k={k} differs"
    # d past the tile's shared memory: the wide route
    for d, k in ((273, 5), (1024, 40)):
        tr = ints((700, d))
        tr[400:600] = tr[0:200]
        te = ints((150, d))
        te[:50] = tr[100:150]
        lab = labels[:700].contiguous()
        got = knn_k.knn_topk_cuda(te, tr, lab, k)
        assert bitwise_equal(got, knn_k.knn_topk_plain(te, tr, lab, k)), \
            f"knn_topk integer case d={d} differs"

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
    normal_case(300, 9000, 20, 100)             # the wide route: k past the lists,
    normal_case(200, 3000, 300, 5)              # d past the tile,
    normal_case(70, 9000, 7, 1000)              # k past a training chunk

    def timed(m, n, d, k):
        test, train, labels, err = normal_case(m, n, d, k)
        t = times(lambda: knn_k.knn_topk_cuda(test, train, labels, k),
                  lambda: knn_k.knn_topk_plain(test, train, labels, k), reps=10, plain_reps=3)
        nbytes = 4.0 * (m * d + n * d + n) + 8.0 * m * k
        fp32_cores = bound(2.0 * m * n * d, nbytes)
        cuda_route = knn_k.route(k, d)
        if cuda_route == "tensor_cores":    # three TF32 products per pair
            bound_ms, bound_by = bound(3 * 2.0 * m * n * d, nbytes, PEAK_TF32_FLOPS)
        else:                               # fp32 FMAs on the CUDA cores
            bound_ms, bound_by = fp32_cores
        return {"shape": {"m": m, "n": n, "d": d, "k": k}, "cuda_route": cuda_route,
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_fp32_cores": fp32_cores[0]}

    # the path shape: one KNN_frag task of phase 4, on the tensor cores
    row = timed(12_500, 125_000, 50, 5)
    assert row["cuda_route"] == "tensor_cores", row["cuda_route"]
    row["wide_shapes"] = [timed(12_500, 125_000, 50, 33), timed(12_500, 125_000, 300, 5)]
    assert all(w["cuda_route"] == "wide" for w in row["wide_shapes"])
    return {"name": "knn_topk", "route": "cuda",
            "source": "src/repro_torch/csrc/knn_topk.cu",
            "replaces": "src/repro/kernels/knn_topk.py:86", **row}


def check_kmeans(km_k, gen, cuda):
    """kmeans_assign kernel vs its plain version; returns the kernels-line row."""
    def ints(shape):
        return torch.from_numpy(gen.integers(-2, 3, size=shape).astype(np.float32)).to(cuda)

    # integer-valued inputs: dot products, |c|^2/2, sums and sse are exact;
    # half-integer scores make argmax ties common
    # the last three past the tensor-core route: the wide route
    for n, d, k in ((5000, 50, 16), (1001, 13, 5), (5000, 50, 65), (3001, 257, 16),
                    (20_000, 300, 1000)):
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
    normal_case(20_011, 300, 1000)              # the wide route, both past

    def timed(n, d, k, parent=False):
        x, c, err = normal_case(n, d, k)
        n = x.shape[0]
        def run():
            return times(lambda: km_k.kmeans_assign_cuda(x, c),
                         lambda: km_k.kmeans_assign_plain(x, c))

        t = with_parent("kmeans_assign", lambda m: m.kmeans_assign_cuda(x, c), run) \
            if parent else run()
        bound_ms, bound_by = bound(2.0 * n * k * d + 3.0 * n * d,
                                   4.0 * (n * d + 2 * k * d + k + 1))
        return {"shape": {"n": n, "d": d, "k": k}, "cuda_route": km_k.route(k, d),
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by}

    # the path shape: one partial_sum task of phase 5, on the tensor cores
    row = timed(500_000, 50, 16, parent=True)
    assert row["cuda_route"] == "tensor_cores", row["cuda_route"]
    row["wide_shapes"] = [timed(500_000, 50, 65), timed(100_000, 257, 16)]
    assert all(w["cuda_route"] == "wide" for w in row["wide_shapes"])
    return {"name": "kmeans_assign", "route": "cuda",
            "source": "src/repro_torch/csrc/kmeans_assign.cu",
            "replaces": "src/repro/kernels/kmeans_assign.py:65", **row}


def close_in_dtype(got, want, what: str) -> float:
    """fp32: within 1e-5 (sums in another order); bf16: within one bf16
    rounding step of each other (two fp32 results that round apart).
    Returns the largest absolute difference."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if got.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_STEP, atol=1e-5,
                                   msg=lambda m: f"{what}: {m}")
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5, msg=lambda m: f"{what}: {m}")
    return (got.float() - want.float()).abs().max().item()


def check_rmsnorm(rms_k, gen, cuda):
    """rmsnorm kernel vs its plain version; returns the kernels-line row."""
    def normal(shape, dtype):
        return torch.from_numpy((gen.standard_normal(shape) * 2).astype(np.float32)) \
            .to(cuda).to(dtype)

    # the serve path's shapes (ln1/ln2 rows of d_model, q/k-norm rows of
    # head_dim, mamba2's 1536 and 3072, recurrentgemma's 4096), ragged row
    # counts, d from 64 to 6144 (every packs-per-lane template and the two-
    # pass rows past them), d off the 16-byte packs, mixed dtypes
    cases = [((8 * 512, 1024), torch.bfloat16, torch.bfloat16),
             ((8 * 512 * 16, 64), torch.bfloat16, torch.bfloat16),
             ((8 * 512, 1024), torch.float32, torch.float32),
             ((1001, 1024), torch.bfloat16, torch.bfloat16),
             ((77, 6144), torch.bfloat16, torch.float32),
             ((8, 4096), torch.bfloat16, torch.bfloat16),
             ((300, 1536), torch.bfloat16, torch.bfloat16),
             ((70, 3072), torch.bfloat16, torch.float32),
             ((33, 2048), torch.float32, torch.float32),
             ((9, 4096), torch.float32, torch.bfloat16),
             ((13, 3, 64), torch.float32, torch.bfloat16),
             ((129, 100), torch.bfloat16, torch.bfloat16),
             ((5, 37), torch.float32, torch.float32)]
    for shape, xdt, sdt in cases:
        x, scale = normal(shape, xdt), normal(shape[-1:], sdt)
        got = rms_k.rmsnorm_cuda(x, scale)
        assert torch.equal(got, rms_k.rmsnorm_cuda(x, scale)), "rmsnorm: two launches differ"
        close_in_dtype(got, rms_k.rmsnorm_plain(x, scale), f"rmsnorm {shape} {xdt}")

    def at_shape(rows, d):
        x, scale = normal((rows, d), torch.bfloat16), normal((d,), torch.bfloat16)
        err = close_in_dtype(rms_k.rmsnorm_cuda(x, scale), rms_k.rmsnorm_plain(x, scale),
                             "rmsnorm timed")
        bound_ms, bound_by = bound(4.0 * rows * d, 2.0 * (2 * rows * d + d))
        t = with_parent("rmsnorm", lambda m: m.rmsnorm_cuda(x, scale),
                        lambda: times(lambda: rms_k.rmsnorm_cuda(x, scale),
                                      lambda: rms_k.rmsnorm_plain(x, scale),
                                      time_library("rmsnorm", x, scale, 1e-6), reps=50,
                                      plain_reps=20))
        # every shape here fits in L2, where the timing loop leaves it
        # between calls: timed again with its inputs in DRAM
        t["cold_ms"] = device_ms(lambda: rms_k.rmsnorm_cuda(x, scale), 50, cold=True)
        t["library_cold_ms"] = time_library("rmsnorm", x, scale, 1e-6, cold=True)
        return {"shape": {"rows": rows, "d": d, "dtype": "bf16"},
                "layout": dict(zip(("lanes_per_row", "packs_per_lane", "one_pass"),
                                   rms_k.layout(d, 2))),
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by}

    row = at_shape(8 * 512, 1024)          # ln1 / ln2 / final norm of the prefill
    row["qk_norm_shape"] = at_shape(8 * 512 * 16, 64)     # qwen's q norm of the prefill
    row["k_norm_shape"] = at_shape(8 * 512 * 8, 64)       # and its k norm
    row["moe_shape"] = at_shape(8 * 512, 2048)            # deepseek's prefill and training
    # one decode step: ln1 / ln2 of qwen (8 x 1024), of recurrentgemma
    # (8 x 4096) and of deepseek (8 x 2048), qwen's q norm (8 x 16 heads x 64)
    row["decode_shapes"] = [at_shape(8, 1024), at_shape(8 * 16, 64), at_shape(8, 4096),
                            at_shape(8, 2048)]
    return {"name": "rmsnorm", "route": "cuda", "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm.py:30", **row}


def check_flash(fa_k, gen, cuda):
    """flash_attention kernel vs its plain version; returns the kernels-line row."""
    def qkv(B, H, K, Sq, Skv, d, dtype):
        # (B, S, heads, d) in memory, seen as (B, heads, S, d): the layer's layout
        def one(heads, S):
            a = torch.from_numpy(gen.standard_normal((B, S, heads, d)).astype(np.float32))
            return a.to(cuda).to(dtype).transpose(1, 2)
        return one(H, Sq), one(K, Skv), one(K, Skv)

    # (B, H, K, Sq, Skv, d, causal, window): the path shape; ragged S;
    # non-causal with Sq < Skv; causal with Sq > Skv; a window whose first
    # streamed KV block is wholly masked for the later query rows (rows
    # >= 228 of the block at 192 see nothing of keys 64..127); windows
    # without causality; d = 16, 32, 128 and 256; G = 1, 16 and 48 (MQA);
    # recurrentgemma's prefill (d 256, K 1, window 2048) and a d 256 window
    # that bites (S 4096 > 2048)
    cases = [(8, 16, 8, 512, 512, 64, True, None),
             (8, 16, 1, 512, 512, 256, True, 2048),
             (1, 16, 1, 4096, 4096, 256, True, 2048),
             (2, 4, 1, 300, 300, 256, True, 100),
             (1, 4, 2, 90, 150, 256, False, None),
             (2, 4, 1, 130, 130, 32, True, 16),
             (1, 4, 4, 70, 40, 32, False, None),
             (2, 4, 2, 77, 77, 64, True, None),
             (1, 4, 4, 40, 200, 64, False, None),
             (1, 4, 2, 150, 70, 64, True, None),
             (1, 4, 2, 300, 300, 64, True, 100),
             (1, 2, 1, 90, 130, 64, False, 33),
             (2, 8, 2, 130, 130, 128, True, None),
             (1, 16, 1, 100, 100, 64, True, None),
             (1, 48, 1, 64, 64, 128, True, None),
             (1, 4, 2, 65, 65, 16, True, 9),
             (1, 4, 4, 33, 33, 16, False, None)]
    for B, H, K, Sq, Skv, d, causal, window in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(B, H, K, Sq, Skv, d, dtype)
            got = fa_k.flash_attention_cuda(q, k, v, causal=causal, window=window)
            assert torch.equal(got, fa_k.flash_attention_cuda(q, k, v, causal=causal,
                                                              window=window)), \
                "flash_attention: two launches differ"
            want = fa_k.flash_attention_plain(q, k, v, causal=causal, window=window)
            close_in_dtype(got, want, f"flash_attention {(B, H, K, Sq, Skv, d, causal, window)} "
                                      f"{dtype}")
    def at_shape(B, H, K, S, d, window):
        q, k, v = qkv(B, H, K, S, S, d, torch.bfloat16)
        err = close_in_dtype(fa_k.flash_attention_cuda(q, k, v, window=window),
                             fa_k.flash_attention_plain(q, k, v, window=window),
                             "flash_attention timed")
        flops = 4.0 * B * H * S * S * d / 2          # causal; the windows here do not bite
        nbytes = 2.0 * (2 * B * H * S * d + 2 * B * K * S * d)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
        return {"shape": {"B": B, "H": H, "K": K, "S": S, "d": d, "causal": True,
                          "window": window, "dtype": "bf16"},
                "max_abs_err": err,
                **times(lambda: fa_k.flash_attention_cuda(q, k, v, window=window),
                        lambda: fa_k.flash_attention_plain(q, k, v, window=window),
                        time_library("flash_attention", q, k, v)),
                "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_fp32_cores": bound(flops, nbytes)[0]}

    row = at_shape(8, 16, 8, 512, 64, None)      # every layer's prefill in phase 7
    # every local_attn layer's prefill in phase 9 (recurrentgemma-9b)
    row["hybrid_shape"] = at_shape(8, 16, 1, 512, 256, 2048)
    # every layer's prefill in phase 10 and forward in phase 14
    # (deepseek-moe-16b: MHA, 16 heads of 128)
    row["moe_shape"] = at_shape(8, 16, 16, 512, 128, None)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:92", **row}


def check_rglru(rg_k, gen, cuda):
    """rglru_scan kernel vs its plain version; returns the kernels-line row."""
    def inputs(B, S, R, dtype, with_h0):
        la = -np.log1p(np.exp(gen.standard_normal((B, S, R))))      # -softplus: a in (0, 1)
        la, b = (torch.from_numpy(a.astype(np.float32)).to(cuda).to(dtype)
                 for a in (la, gen.standard_normal((B, S, R))))
        h0 = (torch.from_numpy(gen.standard_normal((B, R)).astype(np.float32)).to(cuda)
              if with_h0 else None)
        return la, b, h0

    def check(la, b, h0, what):
        y, h = rg_k.rglru_scan_cuda(la, b, h0)
        assert bitwise_equal((y, h), rg_k.rglru_scan_cuda(la, b, h0)), \
            "rglru_scan: two launches differ"
        py, ph = rg_k.rglru_scan_plain(la, b, h0)
        err = close_in_dtype(y, py, f"rglru_scan y {what}")
        close_in_dtype(h, ph, f"rglru_scan h_T {what}")
        return err

    # ragged R (off the 128-channel block), S off the 8-step unroll, an h0,
    # bf16 log_a and b, one step
    for B, S, R, dtype, with_h0 in ((3, 77, 100, torch.float32, False),
                                    (2, 300, 4097, torch.float32, True),
                                    (2, 129, 1000, torch.bfloat16, True),
                                    (1, 1, 37, torch.bfloat16, False)):
        check(*inputs(B, S, R, dtype, with_h0), (B, S, R, dtype, with_h0))
    # the path shape: every rglru layer's prefill in phase 9 (fp32 gates)
    B, S, R = 8, 512, 4096
    la, b, _ = inputs(B, S, R, torch.float32, False)
    err = check(la, b, None, "timed")
    bound_ms, bound_by = bound(3.0 * B * S * R, 4.0 * (3 * B * S * R + B * R))
    return {"name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
            "replaces": "src/repro/kernels/rglru_scan.py:52",
            "shape": {"B": B, "S": S, "R": R, "dtype": "fp32"}, "max_abs_err": err,
            **times(lambda: rg_k.rglru_scan_cuda(la, b), lambda: rg_k.rglru_scan_plain(la, b),
                    reps=20, plain_reps=3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_note": "no single PyTorch call computes a linear recurrence"}


def close_ssd(got, want, what: str) -> float:
    """The kernel steps the recurrence; the plain version forms
    exp(cs_i - cs_j) from fp32 cumulative sums over up to a chunk of steps,
    whose rounding is relative to |cs|: within 1e-4 of the largest value
    and 1e-4 relative.  Returns the largest absolute difference."""
    assert got.dtype == want.dtype and got.shape == want.shape, what
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * float(want.abs().max()),
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def check_ssd(ssd_k, gen, cuda):
    """ssd_scan kernel vs its plain version; returns the kernels-line row."""
    def inputs(B, S, H, P, N, dtype, dt=None):
        # x, B and C as views into one (B, S, H*P + 2N) tensor: the layer's layout
        packed = torch.from_numpy(gen.standard_normal((B, S, H * P + 2 * N)).astype(np.float32))
        packed = packed.to(cuda).to(dtype)
        if dt is None:
            dt = np.log1p(np.exp(gen.standard_normal((B, S, H))))    # softplus
        A = -torch.linspace(1.0, 16.0, H, device=cuda)               # the init's -exp(A_log)
        return (packed[..., :H * P].reshape(B, S, H, P),
                torch.from_numpy(dt.astype(np.float32)).to(cuda), A,
                packed[..., H * P:H * P + N], packed[..., H * P + N:])

    def check(args, chunk, what):
        y, st = ssd_k.ssd_scan_cuda(*args)
        assert bitwise_equal((y, st), ssd_k.ssd_scan_cuda(*args)), \
            "ssd_scan: two launches differ"
        py, pst = ssd_k.ssd_scan_plain(*args, chunk=chunk)
        close_ssd(st, pst, f"ssd_scan state {what}")
        return close_ssd(y, py, f"ssd_scan y {what}")

    # ragged S (543: the full-forward check's length), P and N off the
    # tiles, fp32 x; decays near 0 (dt 5..20) and near 1 (dt < 1e-3) in
    # alternate heads
    check(inputs(2, 543, 8, 64, 128, torch.bfloat16), 256, "S 543")
    check(inputs(2, 77, 3, 40, 100, torch.float32), 32, "P 40, N 100")
    H = 8
    near = np.where(np.arange(H) % 2 == 0, 1e-3, 20.0)
    dt = gen.uniform(0.0, 1.0, (2, 300, H)) * near
    dt = np.where(np.arange(H) % 2 == 0, dt, np.maximum(dt, 5.0))
    check(inputs(2, 300, H, 64, 128, torch.bfloat16, dt), 256, "extreme decays")
    # the path shape: every layer's prefill in phase 8 (mamba2-780m)
    B, S, H, P, N, Q = 8, 512, 48, 64, 128, 256
    args = inputs(B, S, H, P, N, torch.bfloat16)
    err = check(args, Q, "timed")
    flops = B * H * (S // Q) * (2.0 * (Q * N + Q * P) * Q + 4.0 * Q * N * P)
    nbytes = 2.0 * B * S * (H * P + 2 * N) + 4.0 * (B * S * H + H) \
        + 4.0 * (B * S * H * P + B * H * P * N)
    bound_ms, bound_by = bound(flops, nbytes, PEAK_BF16_FLOPS)
    return {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:72",
            "shape": {"B": B, "S": S, "H": H, "P": P, "N": N, "chunk": Q, "dtype": "bf16"},
            "max_abs_err": err,
            **with_parent("ssd_scan", lambda m: m.ssd_scan_cuda(*args),
                          lambda: times(lambda: ssd_k.ssd_scan_cuda(*args),
                                        lambda: ssd_k.ssd_scan_plain(*args, chunk=Q),
                                        reps=20, plain_reps=3)),
            "bound_ms": bound_ms, "bound_by": bound_by,
            # the step-by-step recurrence of the fp32 route: 5 flops per
            # state element and step, on the fp32 CUDA cores
            "bound_ms_fp32_cores": bound(5.0 * B * S * H * P * N, nbytes)[0],
            "library_note": "no single PyTorch call computes the SSD scan"}


# ---------------------------------------------------------------- gradients
def grad_case(ops, name, op, plain, leaves, views, cuda) -> float:
    """Gradients of ``Σ g·out`` (fixed random cotangents ``g`` on every
    output, fp32) with respect to ``leaves``, through ``op`` (the kernel
    in its autograd Function: it must launch once) and through ``plain``
    on the card; ``views(leaves)`` gives the kernel's inputs (the layers'
    strided views).  Each gradient must exist and agree within the
    forward's tolerance: the Function's backward recomputes the plain
    version on the same inputs.  Returns the largest difference."""
    def grads(fn):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn(*views(xs))
        out = out if isinstance(out, tuple) else (out,)
        gen = torch.Generator(device=cuda).manual_seed(1)
        loss = sum((o.float() * torch.randn(o.shape, generator=gen, device=cuda)).sum()
                   for o in out)
        return torch.autograd.grad(loss, xs)

    before = ops.launch_counts()[name]
    got = grads(op)
    assert ops.launch_counts()[name] == before + 1, f"{name}: the Function did not launch"
    want = grads(plain)
    errs = [close_in_dtype(a, b, f"{name} gradient of input {i}")
            for i, (a, b) in enumerate(zip(got, want))]
    return max(errs)


def check_grads(ops, gen, cuda) -> dict:
    """``grad_case`` for each model kernel at its training paths' shapes;
    returns {kernel: [largest difference per shape]}."""
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import rglru_scan as rg_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd_scan as ssd_k

    def normal(shape, dtype):
        return torch.from_numpy(gen.standard_normal(shape).astype(np.float32)).to(cuda).to(dtype)

    def same(xs):
        return xs

    out = {"rmsnorm": [], "flash_attention": [], "ssd_scan": [], "rglru_scan": []}
    # ln1 / ln2 of qwen, its q-norm, mamba2's gated norm, ln1 / ln2 of
    # deepseek (bf16); the reduced configs' norms (fp32)
    for shape, dt in (((8 * 512, 1024), torch.bfloat16), ((8, 512, 16, 64), torch.bfloat16),
                      ((8 * 512, 3072), torch.bfloat16), ((8 * 512, 2048), torch.bfloat16),
                      ((4 * 32, 128), torch.float32)):
        x, scale = normal(shape, dt), normal(shape[-1:], dt)
        out["rmsnorm"].append(grad_case(ops, "rmsnorm", lambda x, s: ops.rmsnorm(x, s),
                                        rms_k.rmsnorm_plain, [x, scale], same, cuda))
    # qwen's prefill (d 64), recurrentgemma's (d 256, window 2048) and
    # deepseek's (d 128, 16 kv heads) in bf16, the reduced recurrentgemma's
    # local attention (fp32, d 32, window 16): (B, S, heads, d) leaves seen
    # as (B, heads, S, d) views
    for B, H, K, S, d, window, dt in ((8, 16, 8, 512, 64, None, torch.bfloat16),
                                      (8, 16, 1, 512, 256, 2048, torch.bfloat16),
                                      (8, 16, 16, 512, 128, None, torch.bfloat16),
                                      (4, 4, 1, 32, 32, 16, torch.float32)):
        leaves = [normal((B, S, H, d), dt), normal((B, S, K, d), dt), normal((B, S, K, d), dt)]
        out["flash_attention"].append(grad_case(
            ops, "flash_attention", lambda q, k, v, w=window: ops.flash_attention(q, k, v, window=w),
            lambda q, k, v, w=window: fa_k.flash_attention_plain(q, k, v, window=w), leaves,
            lambda xs: [t.transpose(1, 2) for t in xs], cuda))
    # mamba2's prefill (bf16) and the reduced mamba2's (fp32): x, B and C
    # as views into one packed leaf (the layer's conv output), dt and A
    for B, S, H, P, N, dt in ((8, 512, 48, 64, 128, torch.bfloat16),
                              (4, 32, 8, 16, 16, torch.float32)):
        packed = normal((B, S, H * P + 2 * N), dt)
        dts = torch.nn.functional.softplus(normal((B, S, H), torch.float32))
        A = -torch.linspace(1.0, 16.0, H, device=cuda)

        def views(xs, H=H, P=P, N=N):
            p, d, a = xs
            return (p[..., :H * P].reshape(*p.shape[:2], H, P), d, a, p[..., H * P:H * P + N],
                    p[..., H * P + N:])
        out["ssd_scan"].append(grad_case(
            ops, "ssd_scan", lambda *a: ops.ssd_scan(*a, chunk=min(256, S)),
            lambda *a, S=S: ssd_k.ssd_scan_plain(*a, chunk=min(256, S)), [packed, dts, A],
            views, cuda))
    # the reduced recurrentgemma's scan (fp32 gates), from zeros and from an h0
    for B, S, R, with_h0 in ((4, 32, 128, False), (2, 77, 1000, True)):
        la = -torch.nn.functional.softplus(normal((B, S, R), torch.float32))
        leaves = [la, normal((B, S, R), torch.float32)] + \
            ([normal((B, R), torch.float32)] if with_h0 else [])
        out["rglru_scan"].append(grad_case(ops, "rglru_scan", lambda *a: ops.rglru_scan(*a),
                                           rg_k.rglru_scan_plain, leaves, same, cuda))
    return out


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


def only(ops, **nonzero) -> dict:
    """The launch counts of a phase that launches ``nonzero`` and nothing else."""
    return {**dict.fromkeys(ops.KERNELS, 0), **nonzero}


@contextlib.contextmanager
def configured(model, cfg):
    """``model`` and each of its blocks run with ``cfg`` (on the same
    weights) inside the ``with`` statement."""
    old = model.cfg
    for m in (model, *model.blocks):
        m.cfg = cfg
    try:
        yield
    finally:
        for m in (model, *model.blocks):
            m.cfg = old


def moe_readings(model, fn) -> tuple:
    """(``fn()``, routes, {"prefill", "decode": the share of token-expert
    assignments that the MoE layers dropped}) of one call of ``fn``, read
    by hooks that route each MoE layer's input again.  ``routes`` is each
    MoE layer's top-k expert ids of every position, in ascending order,
    over ``fn``'s forwards one after the other, (layers, B, S, k); None
    for a model without MoE layers."""
    from repro_torch.layers import moe
    tally = {"prefill": [], "decode": []}
    layers = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]
    ids = {id(mod): [] for mod in layers}

    def hook(mod, args, kwargs):
        x = args[0]
        kw = {k: kwargs[k] for k in ("top_k", "capacity_factor", "renormalize")}
        tally["prefill" if x.shape[1] > 1 else "decode"].append(
            moe.dropped_assignments(mod.params(), x, **kw))
        _, topi, _ = moe._route(x.reshape(-1, x.shape[-1]), mod.w_router, kw["top_k"],
                                kw["renormalize"])
        ids[id(mod)].append(topi.sort(dim=-1).values.view(*x.shape[:2], -1))

    handles = [mod.register_forward_pre_hook(hook, with_kwargs=True) for mod in layers]
    try:
        out = fn()
    finally:
        for h in handles:
            h.remove()
    routes = torch.stack([torch.cat(ids[id(mod)], dim=1) for mod in layers]) if layers else None
    return out, routes, {k: sum(int(d) for d, _ in v) / max(1, sum(n for _, n in v))
                         for k, v in tally.items()}


@contextlib.contextmanager
def routed_as(model, routes):
    """Inside the ``with`` statement each MoE layer of ``model`` sends
    every token to the experts ``routes`` (layers, B, S, k) names for its
    position (another run's routing, as :func:`moe_readings` reads it),
    weighted by its own router's probabilities of them."""
    from repro_torch.layers import moe
    route = moe._route
    layers = [blk.moe for blk in model.blocks if hasattr(blk, "moe")]
    given = {id(mod.w_router): ids.reshape(-1, ids.shape[-1]) for mod, ids in zip(layers, routes)}

    def forced(xf, w_router, top_k, renormalize=True):
        _, _, aux = route(xf, w_router, top_k, renormalize)
        ids = given[id(w_router)]
        w = torch.softmax(xf.to(torch.float32) @ w_router, dim=-1).gather(1, ids)
        if renormalize:
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
        return w, ids, aux

    moe._route = forced
    try:
        yield
    finally:
        moe._route = route


def serve_and_check(ph, cfg, model, want_counts, cuda, compare_cfg=None) -> tuple:
    """Serve ``model`` (BATCH prompts of PROMPT_LEN tokens, GEN_LEN
    generated tokens each) twice and check it: the launch counts are
    ``want_counts``; the two runs give the same tokens; the replayed
    logits choose the served tokens; one cache-free forward over prompt +
    generated tokens is within ``LOGIT_TOL`` of them and chooses their
    argmax wherever its top-2 margin is clear; a replay fed the token
    before each served one (the lagged control) is not.  With
    ``compare_cfg`` (the same model at another capacity factor) the full
    forward, the replay it is held against and the control run with that
    config; a MoE model's drop shares are read in the served config's
    replay.  In a MoE model the share of the generated positions' choices
    of experts (one per position and layer) that the two paths make apart
    is at most ``MAX_ROUTED_APART`` and the lagged control's is above it,
    and the full forward held is the one with the replay's routing forced.  Then
    one more serve under the profiler for the device's idle share.  Fills
    ``ph.info``
    and returns (prompts, tokens, full-forward logits)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    tol = LOGIT_TOL[cfg.name]
    kw = dict(batch=BATCH, prompt_len=PROMPT_LEN, gen_len=GEN_LEN, seed=SEED, device=cuda,
              params=model)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = serve.serve_batch(cfg, **kw)
    counts = ops.launch_counts()
    assert counts == want_counts, (counts, want_counts)
    toks = out["tokens"]
    assert toks.shape == (BATCH, GEN_LEN) and toks.dtype == np.int32
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    again = serve.serve_batch(cfg, **kw)
    assert np.array_equal(toks, again["tokens"]), "two serve runs gave different tokens"
    # the logits each token was chosen from, replayed: the same prefill
    # and decode steps fed the served tokens, which they must choose again
    prompts = serve.make_prompts(cfg, BATCH, PROMPT_LEN, SEED)
    logits, routes, drops = moe_readings(
        model, lambda: serve.replay_logits(model, prompts, toks, seed=SEED))
    assert logits.shape == (BATCH, GEN_LEN, cfg.vocab_size) and bool(logits.isfinite().all())
    assert np.array_equal(logits.argmax(-1).cpu().numpy(), toks), \
        "the replayed steps choose other tokens than the served ones"
    # one cache-free forward over prompt + generated tokens (every prefill
    # kernel over all positions) against the served logits (prefill, then
    # the decode path over the caches)
    seq = torch.from_numpy(np.concatenate([prompts["tokens"], toks[:, :-1]], axis=1)).to(cuda)
    flips = {}
    with configured(model, compare_cfg or cfg), torch.no_grad():
        ref = logits
        if compare_cfg is not None:
            ref, routes, _ = moe_readings(
                model, lambda: serve.replay_logits(model, prompts, toks, seed=SEED))

        def forward():
            return model({"tokens": seq})[0][:, PROMPT_LEN - 1:]

        full, full_routes, _ = moe_readings(model, forward)
        if routes is not None:
            # a rounding apart flips near-ties among some positions' top-k
            # experts, and such a token mixes other experts from there on:
            # counted here, and held below with the replay's routing forced
            flipped = (full_routes != routes).any(-1)[:, :, PROMPT_LEN - 1:]  # (layers, B, G)
            flips = {"routed_apart_share": float(flipped.float().mean()),
                     "positions_routed_apart": int(flipped.any(0).sum()),
                     "free_routing_max_abs_diff": float((full - ref).abs().max())}
            with routed_as(model, routes):
                full = forward()
        # control: every decode step fed the token before the one served, as
        # a cache or position off by one would; the check must fail on it
        lagged = np.concatenate([toks[:, :1], toks[:, :-1]], axis=1)
        lagged_logits, lagged_routes, _ = moe_readings(
            model, lambda: serve.replay_logits(model, prompts, lagged, seed=SEED))
        lagged_diff = (full - lagged_logits).abs()
        if routes is not None:
            flips["control_lagged_routed_apart_share"] = float(
                (full_routes != lagged_routes).any(-1)[:, :, PROMPT_LEN - 1:].float().mean())
    diff = (full - ref).abs()
    control_lagged = float(lagged_diff.max())

    def quantiles(v):
        return {q: float(v.quantile(q)) for q in (0.5, 0.9, 0.99)}

    emit({"readings": ph.name, "logits_max_abs_diff": float(diff.max()),
          "logits_rms_diff": float(diff.pow(2).mean().sqrt()),
          "per_position_max_diff_quantiles": quantiles(diff.amax(dim=-1).flatten()),
          **flips, "control_lagged_tokens": control_lagged,
          "control_lagged_quantiles": quantiles(lagged_diff.amax(dim=-1).flatten()),
          "logits_tol": tol, **({"dropped_share": drops} if compare_cfg is not None else {})})
    assert float(diff.max()) <= tol, f"full forward vs served logits: {float(diff.max())}"
    assert control_lagged > tol, \
        f"the check does not see decode fed the wrong tokens: {control_lagged}"
    if flips:
        assert flips["routed_apart_share"] <= MAX_ROUTED_APART, \
            f"the two paths route {flips['routed_apart_share']} of the choices apart"
        assert flips["control_lagged_routed_apart_share"] > MAX_ROUTED_APART, \
            f"the routing check does not see decode fed the wrong tokens: {flips}"
    top2 = full.topk(2, dim=-1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) > 2 * tol
    agree = top2.indices[..., 0].cpu().numpy() == ref.argmax(-1).cpu().numpy()
    assert agree[clear.cpu().numpy()].all(), "full-forward argmax differs from a decoded token"
    ph.info.update(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                   params=sum(p.numel() for p in model.parameters()),
                   batch=BATCH, prompt_len=PROMPT_LEN, gen_len=GEN_LEN,
                   prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                   decode_tokens_per_s=out["decode_tokens_per_s"],
                   second_run={k: again[k] for k in ("prefill_s", "decode_s",
                                                     "decode_tokens_per_s")},
                   launches=counts, logits_max_abs_diff=float(diff.max()),
                   logits_rms_diff=float(diff.pow(2).mean().sqrt()), **flips,
                   logits_tol=tol, control_lagged_tokens=control_lagged,
                   clear_positions=int(clear.sum()), argmax_agree=int(agree.sum()),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if compare_cfg is not None:
        ph.info.update(dropped_share=drops, compared_at={
            "moe_capacity_factor": compare_cfg.moe_capacity_factor,
            "served_argmax_agree": int((ref.argmax(-1).cpu().numpy() == toks).sum())})
    # where the device time goes: one more run under the profiler (CUDA
    # activity only), its kernels' device time against the unprofiled
    # second run's wall time
    _, table = device_kernels(lambda: serve.serve_batch(cfg, **kw))
    busy_s = sum(ms for ms, _ in table.values()) / 1e3
    wall_s = again["prefill_s"] + again["decode_s"]
    ours = {name: sum(ms for key, (ms, _) in table.items() if tag in key) / 1e3
            for name, tag in (("rmsnorm", "rmsnorm_rows"), ("flash_attention", "flash_fwd"),
                              ("rglru_scan", "rglru_scan_kernel"),
                              ("ssd_scan", "ssd_"))}
    top = sorted(table.items(), key=lambda kv: -kv[1][0])[:10]
    ph.info["device"] = {"busy_s": busy_s, "wall_s": wall_s,
                         "idle_share": 1.0 - busy_s / wall_s, "kernel_s": ours,
                         "top": [[key[:80], ms, n] for key, (ms, n) in top]}
    emit({ph.name: {k: ph.info[k] for k in ("prefill_s", "decode_s", "decode_tokens_per_s",
                                            "peak_mem_gb")},
          "idle_share": ph.info["device"]["idle_share"]})
    return prompts, toks, full


def train_launches(ops, cfg) -> dict:
    """Kernel launches of one training step of ``cfg``: each norm (ln1,
    ln2 or the SSD's gated norm, the q/k norms), cache-free attention and
    scan once in the forward, and once more where remat "full" runs each
    block's forward again in the backward; the final norm, outside the
    blocks, once.  The MoE experts launch no kernel of the port."""
    attention = ("dense", "local_attn", "moe")
    kinds = cfg.layer_types
    norms = sum(2 + (2 if t in attention and cfg.qk_norm else 0) for t in kinds)
    again = 2 if cfg.remat == "full" else 1
    return only(ops, rmsnorm=again * norms + 1,
                flash_attention=again * sum(t in attention for t in kinds),
                ssd_scan=again * kinds.count("ssd"), rglru_scan=again * kinds.count("rglru"))


def train_parity(ph, ops, lm, train, get_config, cuda) -> dict:
    """Phase train_parity: the summed launch counts of the five card runs."""
    total = only(ops)
    for arch in ("qwen3-0.6b", "mamba2-780m", "recurrentgemma-9b", "deepseek-moe-16b",
                 "qwen3-moe-235b-a22b"):
        cfg = get_config(arch, reduced=True)
        on_cpu = train.train_loop(cfg, device="cpu",
                                  model=lm.init_params(cfg, seed=SEED, device="cpu"), **PARITY)
        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        ckpt = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="chip_smoke_ckpt_")
        try:
            ops.reset_launch_counts()
            on_card = train.train_loop(cfg, device=cuda,
                                       model=lm.init_params(cfg, seed=SEED, device="cpu").to(cuda),
                                       ckpt_dir=ckpt, ckpt_every=2, **PARITY)
            counts = ops.launch_counts()
            want = {k: PARITY["steps"] * n for k, n in train_launches(ops, cfg).items()}
            assert counts == want, (arch, counts, want)
            total = {k: total[k] + n for k, n in counts.items()}
            card, host = np.array(on_card["losses"]), np.array(on_cpu["losses"])
            assert card.shape == (PARITY["steps"],) and np.isfinite(card).all()
            np.testing.assert_allclose(card, host, rtol=PARITY_RTOL,
                                       err_msg=f"{arch}: card vs CPU losses")
            aux = np.array(on_card["aux"])
            if "moe" in cfg.block_pattern:      # the balance loss reached the step
                assert np.isfinite(aux).all() and (aux > 0).all(), (arch, aux)
            # the checkpoint of step 2, written by the checkpoint_save task,
            # restored into a fresh model (other weights) that continues
            shutil.rmtree(os.path.join(ckpt, f"step_{PARITY['steps']:08d}"))
            fresh = lm.init_params(cfg, seed=SEED + 1, device="cpu").to(cuda)
            resumed = train.train_loop(cfg, device=cuda, model=fresh, ckpt_dir=ckpt,
                                       restore=True, **PARITY)
            assert resumed["restored_from"] == 2, resumed["restored_from"]
            np.testing.assert_allclose(resumed["losses"], card[2:], rtol=1e-5,
                                       err_msg=f"{arch}: resumed vs uninterrupted losses")
        finally:
            shutil.rmtree(ckpt, ignore_errors=True)
        ph.info[arch] = {"card_losses": card.tolist(), "cpu_losses": host.tolist(),
                         "max_rel_diff": float(np.abs(card / host - 1).max()),
                         "resumed_losses": resumed["losses"], "launches": counts}
        if "moe" in cfg.block_pattern:
            ph.info[arch].update(card_aux=aux.tolist(), cpu_aux=on_cpu["aux"])
    return total


def train_and_check(ph, ops, lm, train, cfg, cuda) -> dict:
    """Phases train, train_ssd and train_moe: ``train_loop`` on ``cfg`` at
    full width for TRAIN_STEPS steps of BATCH x PROMPT_LEN tokens, checked (finite
    losses, the first near ln(vocab), exact launch counts, the first
    batch's loss lower after training); then, from a fresh optimizer
    state, one step on a new batch, which must lower its loss, timed, and
    one under the profiler for the device's idle share.  Fills
    ``ph.info`` and returns the launch counts."""
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.distributed.steps import make_train_step
    from repro_torch.optim.adamw import adamw, cosine_schedule
    kw = dict(steps=TRAIN_STEPS, batch=BATCH, seq=PROMPT_LEN, lr=1e-3, warmup=2, seed=SEED)
    model = lm.init_params(cfg, seed=SEED, device=cuda)

    def on_card(step):
        return {k: torch.from_numpy(v).to(cuda)
                for k, v in synth_batch(cfg, BATCH, PROMPT_LEN, step, SEED).items()}

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = train.train_loop(cfg, device=cuda, model=model, log_every=0, **kw)
    counts = ops.launch_counts()
    per_step = train_launches(ops, cfg)
    assert counts == {k: TRAIN_STEPS * n for k, n in per_step.items()}, (counts, per_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = np.array(out["losses"])
    assert losses.shape == (TRAIN_STEPS,) and np.isfinite(losses).all(), losses
    assert abs(losses[0] - np.log(cfg.vocab_size)) <= 1.0, (losses[0], np.log(cfg.vocab_size))
    # the model learned what it was taught: its loss on the first batch,
    # after the ten steps, lies below the untrained model's (step 0's).
    # Each batch is another random walk of tokens: the losses of later
    # steps, on other batches, move by less than the batches differ
    # (PERF.md, section 6), so they are recorded, not held
    with torch.no_grad():
        first_after = float(lm.loss_fn(model, on_card(0))[1]["loss"])
    assert first_after < losses[0], (first_after, losses[0])
    # one more step on a fresh optimizer state: its wall time (ending in a
    # sync), then the same step under the profiler
    opt = adamw(cosine_schedule(kw["lr"], kw["warmup"], TRAIN_STEPS), weight_decay=0.01)
    state = opt.init(dict(model.named_parameters()))
    step = make_train_step(opt)
    batch = on_card(TRAIN_STEPS)
    with torch.no_grad():
        before = float(lm.loss_fn(model, batch)[1]["loss"])
    step(model, state, batch)
    with torch.no_grad():
        after = float(lm.loss_fn(model, batch)[1]["loss"])
    assert after < before, ("one step did not lower the loss on its batch", before, after)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(model, state, batch)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    _, table = device_kernels(lambda: step(model, state, batch))
    busy_s = sum(ms for ms, _ in table.values()) / 1e3
    ours = {name: sum(ms for key, (ms, _) in table.items() if tag in key) / 1e3
            for name, tag in (("rmsnorm", "rmsnorm_rows"), ("flash_attention", "flash_fwd"),
                              ("rglru_scan", "rglru_scan_kernel"), ("ssd_scan", "ssd_"))}
    top = sorted(table.items(), key=lambda kv: -kv[1][0])[:12]
    steady = float(np.median(out["step_seconds"][1:]))
    ph.info.update(arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model, remat=cfg.remat,
                   params=sum(p.numel() for p in model.parameters()), batch=BATCH,
                   seq=PROMPT_LEN, steps=TRAIN_STEPS, losses=losses.tolist(),
                   first_batch_after=first_after, one_step_descent=[before, after],
                   last3_vs_first=float(losses[-3:].mean() - losses[0]),
                   ln_vocab=float(np.log(cfg.vocab_size)), step_seconds=out["step_seconds"],
                   steady_step_s=steady, steady_tokens_per_s=BATCH * PROMPT_LEN / steady,
                   tokens_per_s=out["tokens_per_s"], peak_mem_gb=peak_gb,
                   launches=counts, launches_per_step=per_step, aux=out["aux"],
                   device={"busy_s": busy_s, "wall_s": wall_s, "idle_share": 1.0 - busy_s / wall_s,
                           "kernel_s": ours, "top": [[key[:80], ms, n] for key, (ms, n) in top]})
    emit({ph.name: {k: ph.info[k] for k in ("steady_step_s", "steady_tokens_per_s",
                                            "tokens_per_s", "peak_mem_gb",
                                            "first_batch_after", "last3_vs_first")},
          "idle_share": ph.info["device"]["idle_share"]})
    del model, state, opt, step, batch
    torch.cuda.empty_cache()
    return counts


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout whose kmeans_assign, ssd_scan and rmsnorm kernels are "
                         "timed beside this one's")
    args = ap.parse_args(argv)
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
    from repro_torch.kernels import flash_attention as fa_k
    from repro_torch.kernels import rglru_scan as rg_k
    from repro_torch.kernels import rmsnorm as rms_k
    from repro_torch.kernels import ssd_scan as ssd_k
    from repro_torch.configs import get_config
    from repro_torch.launch import serve, train
    from repro_torch.models import lm

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
        lib = _build.library()
        ph.info.update(build_seconds=_build.build_seconds, ptxas=[
            line.strip() for line in _build.build_log.splitlines()
            if "Compiling entry" in line or "Used" in line or "spill" in line])
        ph.info["tensor_cores"] = check_tensor_core_build(_build.build_log, lib._name)
        ph.info["rmsnorm_registers"] = check_rmsnorm_build(_build.build_log)
        if args.parent:
            PARENT.update(load_parent(args.parent))
            PARENT["kmeans_assign"]._build.library()
            ph.info["parent"] = args.parent

    with Phase("kernels") as ph:
        rows = [check_knn(knn_k, gen, cuda), check_kmeans(km_k, gen, cuda),
                check_rmsnorm(rms_k, gen, cuda), check_flash(fa_k, gen, cuda),
                check_rglru(rg_k, gen, cuda), check_ssd(ssd_k, gen, cuda)]
        ph.info["kernels"] = [{k: r[k] for k in ("name", "max_abs_err", "ms", "plain_ms",
                                                 "bound_ms")} for r in rows]
        grad_errs = check_grads(ops, gen, cuda)
        for row in rows:
            if row["name"] in grad_errs:
                row["grad_max_abs_err"] = grad_errs[row["name"]]
        ph.info["grad_max_abs_err"] = grad_errs

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
        assert counts == only(ops, knn_topk=64), counts
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
        assert counts == only(ops, kmeans_assign=160), counts
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
        assert ops.launch_counts() == only(ops)
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

    by_phase = {}          # serve phase -> its launch counts
    with Phase("serve") as ph:
        cfg = get_config("qwen3-0.6b")
        model = lm.init_params(cfg, seed=SEED, device=cuda)
        # 32 forwards (one prefill, 31 decode steps), each with 4 norms per
        # layer (ln1, ln2, q-norm, k-norm) and the final norm; the flash
        # kernel serves the cache-free prefill only, once per layer
        prompts, toks, full = serve_and_check(
            ph, cfg, model, only(ops, rmsnorm=GEN_LEN * (cfg.n_layers * 4 + 1),
                                 flash_attention=cfg.n_layers), cuda)
        by_phase["serve"] = ph.info["launches"]
        # control (2): the decode path with bf16 scores and probabilities (the
        # chunked path under attn_scores_bf16, the same weights from the same
        # seed): a lower precision, recorded
        low = lm.init_params(dataclasses.replace(cfg, attn_impl="chunked", attn_scores_bf16=True),
                             seed=SEED, device=cuda)
        assert all(torch.equal(a, b) for a, b in zip(model.parameters(), low.parameters()))
        ph.info["control_bf16_scores"] = float(
            (full - serve.replay_logits(low, prompts, toks, seed=SEED)).abs().max())
        del low, model, full
        torch.cuda.empty_cache()

    with Phase("serve_ssd") as ph:
        cfg = get_config("mamba2-780m")
        model = lm.init_params(cfg, seed=SEED, device=cuda)
        # per forward: ln1 and the SSD's gated norm in each of 48 layers, and
        # the final norm; the scan kernel serves the prefill, once per layer
        serve_and_check(ph, cfg, model, only(ops, rmsnorm=GEN_LEN * (cfg.n_layers * 2 + 1),
                                             ssd_scan=cfg.n_layers), cuda)
        by_phase["serve_ssd"] = ph.info["launches"]
        del model
        torch.cuda.empty_cache()

    with Phase("serve_hybrid") as ph:
        cfg = get_config("recurrentgemma-9b")
        model = lm.init_params(cfg, seed=SEED, device=cuda)
        kinds = cfg.layer_types
        # per forward: ln1 and ln2 in each of 38 layers, and the final norm;
        # in the prefill, the RG-LRU scan once per rglru layer and the flash
        # kernel once per local_attn layer
        serve_and_check(ph, cfg, model,
                        only(ops, rmsnorm=GEN_LEN * (cfg.n_layers * 2 + 1),
                             rglru_scan=kinds.count("rglru"),
                             flash_attention=kinds.count("local_attn")), cuda)
        by_phase["serve_hybrid"] = ph.info["launches"]
        del model
        torch.cuda.empty_cache()

    with Phase("serve_moe") as ph:
        cfg = get_config("deepseek-moe-16b")
        model = lm.init_params(cfg, seed=SEED, device=cuda)
        # per forward: ln1 and ln2 in each of 28 layers, and the final norm;
        # the flash kernel serves the prefill, once per layer.  The
        # full-forward comparison runs at capacity factor E / k: no drops
        serve_and_check(ph, cfg, model, only(ops, rmsnorm=GEN_LEN * (cfg.n_layers * 2 + 1),
                                             flash_attention=cfg.n_layers), cuda,
                        compare_cfg=dataclasses.replace(
                            cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k))
        by_phase["serve_moe"] = ph.info["launches"]
        del model
        torch.cuda.empty_cache()

    with Phase("train_parity") as ph:
        by_phase["train_parity"] = train_parity(ph, ops, lm, train, get_config, cuda)
        ph.info["launches"] = by_phase["train_parity"]

    with Phase("train") as ph:
        by_phase["train"] = train_and_check(ph, ops, lm, train, get_config("qwen3-0.6b"), cuda)

    with Phase("train_ssd") as ph:
        by_phase["train_ssd"] = train_and_check(ph, ops, lm, train, get_config("mamba2-780m"),
                                                cuda)

    with Phase("train_moe") as ph:
        cfg = get_config("deepseek-moe-16b")
        ph.info["full_depth"] = cfg.n_layers
        by_phase["train_moe"] = train_and_check(
            ph, ops, lm, train, dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS), cuda)

    for name in ("rmsnorm", "flash_attention", "rglru_scan", "ssd_scan"):
        launches[name] = sum(counts[name] for counts in by_phase.values())
    for row in rows:
        if row["name"] in launches and row["name"] not in ("knn_topk", "kmeans_assign"):
            row["launches_by_phase"] = {phase: counts[row["name"]]
                                        for phase, counts in by_phase.items()
                                        if counts[row["name"]]}
    for row in rows:
        row["launches"] = launches[row["name"]]
        assert row["launches"] > 0, f"{row['name']} was not launched on its path"
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "shape")
    emit({"kernels": [{**{k: row[k] for k in keys}, **row} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
