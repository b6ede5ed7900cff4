#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``--parent DIR`` also times the kernels of another checkout of the
repository (for example ``git archive`` of the parent commit unpacked
into ``build/parent``) beside this one's, in the same process on the same
inputs, for ``knn_topk`` and ``kmeans_assign`` (the shapes their narrow
routes take: the path shape and the edges k 32 / d 64, k 64 / d 256),
bf16 ``ssd_scan`` and ``rmsnorm`` (every timed shape): their rows then
carry ``parent_ms``, read before and after this checkout's kernel.

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
             ``knn_topk`` are also checked (integer inputs bitwise,
             random ones within tolerance, two launches bitwise) and
             timed at shapes past their tensor-core routes (their rows'
             ``wide_shapes``: the depth-streamed wide CUDA routes) and at
             each route's edges, k and d one either side (``edge_pairs``),
             and each row names the route it took; each tensor-core route
             is also held at its widest on points far from the origin
             (``far_case``: knn d 64, k 32; kmeans d 256, k 64 on
             run_kmeans's own fills), where an accumulator carried through
             the depth drifts;
4. knn     — run_knn on 2M x 50 training rows, 50k test rows;
5. kmeans  — run_kmeans on 8M x 50 points, k=16, 10 iterations, twice;
6. linreg  — run_linreg on 2M x 100 rows;
7. simulate — the three pipelines' cost models calibrated on the card at
             their own task sizes (each call timed between two
             synchronisations), their DAGs at this script's sizes
             projected at 1..128 workers on one node (Graham's bounds
             hold at every width), each pipeline run once more on one
             worker: the 1-worker projection within 2x of that wall, and
             the run's measured DAG replayed beside it; the launches
             are exactly the calibration's and one run's;
8. process — the three pipelines in 4 spawned worker processes (each its
             own CUDA context), bitwise equal to phases 4-6, with the
             workers' launch counts gathered from their replies; every
             worker holds card memory (its allocator's reserved bytes,
             reported with its replies; the card's used memory covers
             them and the parent's); one worker killed
             during KNN_frag, retried to the same predictions and
             exactly one more run's launches; no segment the plane held
             left in /dev/shm after runtime_stop;
9. dashboard — inside phase 8, every endpoint of the process runtime's
             dashboard fetched and held against the runtime;
10. cluster — the three pipelines on 2 TCP node agents x 2 spawned
             workers (``backend="cluster"``; each worker its own CUDA
             context, the agents none), bitwise equal to phases 4-6; the
             launches gathered from the agents' done replies exactly 64
             ``knn_topk`` / 160 ``kmeans_assign`` and none in this
             process; no agent initialised CUDA, every pool worker holds
             card memory; each pipeline's scheduler relay, peer-fetch and
             p2p bytes and node-resident results, KNN's relay under 5% of
             its fill bytes; one agent SIGKILLed during KNN_frag: exactly
             one respawn, the predictions bitwise equal through lineage
             re-execution, the ``knn_topk`` launches 64 plus one per
             KNN_frag completion the tracer records in that run; after
             runtime_stop no agent process, pool worker or segment an
             agent reported is left;
11. wide   — run_knn on 500k x 384 training rows, 20k test rows, k 50
             (16 fragments x 4 test blocks) and run_kmeans on 1M x 384
             points, k 100, 5 iterations, twice: both past the tensor-core
             routes; held as phases 4 and 5 hold theirs (>= 999/1000
             sampled predictions equal a float64 oracle; SSE
             non-increasing, two runs bitwise equal), launches exactly the
             runs' tasks; one KNN_frag and one partial_sum at those
             shapes held against the plain version on the runs' data
             (near-ties scaled to the data's norms) and on tied integers
             (bitwise), two launches bitwise, then their device time;
12. serve  — serve_batch on qwen3-0.6b at full width (28 layers, d 1024,
             bf16, random weights from seed 0): 8 prompts of 512 tokens,
             32 generated tokens each, twice; then one cache-free forward
             over prompt + generated tokens, held against the served
             logits (replayed) and against two controls;
13. serve_ssd    — the same on mamba2-780m at full width (48 SSD layers,
             d 1536, 48 heads x 64, state 128, bf16), one control;
14. serve_hybrid — the same on recurrentgemma-9b at full width (38 layers =
             12 x (rglru, rglru, local_attn) + 2 rglru, d 4096, MQA with
             head dim 256, window 2048, bf16, 9.6B parameters), one control;
15. serve_moe — the same on deepseek-moe-16b at full width (28 layers,
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
16. train_parity — ``train_loop`` on the reduced qwen3, mamba2,
             recurrentgemma, deepseek-moe and qwen3-moe configs (fp32), 4
             steps on the card and on the CPU from the same
             ``init_params`` weights and batches: the losses agree within
             1e-4, the MoE balance loss is finite and nonzero; a
             checkpoint saved at step 2 by the runtime's
             ``checkpoint_save`` task restores into a fresh model on the
             card, which continues as the uninterrupted run did;
17. train  — ``train_loop`` on qwen3-0.6b at full width (bf16, remat
             "full"), batch 8 x 512 tokens, 10 steps: finite losses, the
             first within 1.0 of ln(vocab), exact launch counts, the loss
             on the first batch lower after the ten steps; one more step
             must lower the loss on its batch, and one under the profiler
             gives the device's idle share;
18. train_ssd — the same on mamba2-780m at full width;
19. train_moe — the same on deepseek-moe-16b at full width, its depth cut
             to 4 of 28 layers (at full depth, bf16 weights and gradients
             and fp32 moments need ~200 GB);
20. mesh   — the multi-device layer at world size 1: an NCCL process group
             of one rank on the card and ``make_local_mesh()``'s (1, 1)
             DeviceMesh; ``train_loop(mesh=)`` on qwen3-0.6b at full width
             (parameters and moments stored as DTensors, gathered for
             compute every step), 4 steps of BATCH x PROMPT_LEN tokens
             with a checkpoint after step 3, and the same 4 steps without
             a mesh from the same seed, checkpointed alike: the losses
             bitwise equal, the
             launches exactly phase train's per step; a launch on the mesh
             restored from the step-3 checkpoint through
             ``restore_checkpoint(shardings=)`` continues with step 4's
             loss within 1e-5; ``serve_batch(mesh=)`` at phase serve's
             settings gives phase serve's tokens with its launch counts;
             the two runs' step seconds and tokens/s on one line beside
             nvidia-smi's name and power limit; the group destroyed;
21. tp_ep  — the tensor- and expert-parallel layers at full width, bf16,
             BATCH x PROMPT_LEN tokens.  (a) On an NCCL group of one rank
             and its (1, 1) mesh, called directly (at one model rank the
             model routes to none of them, as the reference's does not):
             the TP attention and MLP sublayers at granite-3-2b's width
             (d 2048, GQA 32 / 8 x 64, d_ff 8192), the TP RG-LRU and
             local-attention sublayers at recurrentgemma-9b's (d 4096,
             rnn 4096, MQA 16 x 256, window 2048), forward and backward,
             and ``moe_apply_sharded`` at deepseek-moe-16b's layer (64
             experts x 1408, top-6, d 2048) twice: each sublayer's output
             bitwise the plain layers' (``Attention``, ``MLP``,
             ``RGLRU``), the gradients of its input and weights within
             TP_GRAD_STEPS bf16 steps; the MoE bitwise ``moe_apply_local``
             and bitwise across its two calls; launches exactly rmsnorm 4,
             flash_attention 2, rglru_scan 1; flash and rglru_scan also
             held against their plain versions at the shapes two and four
             model ranks give them; each sublayer's forward time (CUDA
             events, plain and TP in turns) beside the plain layers'.  (b) Two spawned ranks sharing the card over a
             gloo group (CUDA tensors) and a (1, 2) mesh built here:
             ``train_loop(mesh=)`` with ``tp_block="shard_map"`` on
             granite-3-2b (4 of 40 layers: TP sublayers) and
             deepseek-moe-16b (2 of 28 layers: TP attention, the experts
             over the two ranks), 4 steps each, against the same 4 steps
             at world size 1 on the card: the ranks' losses equal, within
             TP_EP_LOSS_ATOL of one rank's, launches exactly phase
             train's count per step on each rank; step seconds and
             nvidia-smi's name and power limit printed;
22. codecs — the paper's Table 1 on the card's host: the port's
             ``benchmark_codecs`` at 1024, 4096 and 8192 square float64
             blocks, 3 repeats, one line per codec and size with its
             serialize and deserialize seconds beside the card's own
             crossing of that block (``.cpu()`` and the upload back) and
             nvidia-smi's name and power limit; every codec holds every
             size, every time finite and positive, the 1024 block bitwise
             through each codec, the mmap file and a spill.

Phase 3 also holds the gradients through each model kernel's autograd
Function (the kernel's forward, the plain version's backward) against
autograd through the plain version.  Each serve and train phase frees its
model before the next.  Then a ``{"kernels": [...]}`` line (launches
counted during phases 4, 5, 7, 8, 10, 11 and 12-21, by phase; times measured in
phase 3)
and, last, ``{"ok": true, "device": {...}}``.
The script imports nothing of the JAX package; it needs one CUDA card
and the repository's ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

sys.path.insert(0, os.path.join(ROOT, "src"))
# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit: the port's
# one copy of the peaks (its roofline divides by them too)
from repro_torch.launch.mesh import HBM_BYTES_PER_S as PEAK_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_BF16_FLOPS, PEAK_FP32_FLOPS, PEAK_TF32_FLOPS  # noqa: E402,F401
BF16_STEP = 2.0 ** -7          # one bf16 rounding step, relative

SEED = 0
# served vs full-forward logits, per served model (phases 12-15): logits
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


def event_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Milliseconds of one call of ``fn`` on the card: CUDA events around
    ``reps`` calls after ``warmup``.  For a call of many kernels (a
    sublayer with its all-reduce), whose profiler windows lost events in
    a whole run on the H100 (the same counts short five tries running)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
            for name in ("knn_topk", "kmeans_assign", "ssd_scan", "rmsnorm")}


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
                       for nk in (1, 2, 4, 8) for al in (True, False)] + \
                      [("knn_wide_topk", r"knn_wide_topk")] + \
                      [(f"kmeans_wide_partials<{nt}>", rf"kmeans_wide_partialsILi{nt}E")
                       for nt in range(2, 17, 2)]


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
def knn_tied(gen, cuda, m, n, d, dup=None, same=None):
    """Integer-valued inputs: every distance is exact, and ``dup``
    duplicated training rows (with other labels; n / 5 unless given) and
    ``same`` test rows equal to training rows (m / 6) make ties
    everywhere."""
    def ints(shape):
        return torch.from_numpy(gen.integers(-3, 4, size=shape).astype(np.float32)).to(cuda)

    dup = n // 5 if dup is None else dup
    same = m // 6 if same is None else same
    train = ints((n, d))
    train[n // 2:n // 2 + dup] = train[0:dup]
    test = ints((m, d))
    test[:same] = train[n // 10:n // 10 + same]
    labels = torch.from_numpy(gen.integers(0, 4, size=n).astype(np.int32)).to(cuda)
    return test, train, labels


def knn_exact_case(knn_k, gen, cuda, m, n, d, k, **ties) -> None:
    """Tied integer inputs: two launches bitwise equal, and bitwise the
    plain version's result."""
    test, train, labels = knn_tied(gen, cuda, m, n, d, **ties)
    got = knn_k.knn_topk_cuda(test, train, labels, k)
    assert bitwise_equal(got, knn_k.knn_topk_cuda(test, train, labels, k)), \
        f"knn_topk: two launches differ on integer inputs {(m, n, d, k)}"
    assert bitwise_equal(got, knn_k.knn_topk_plain(test, train, labels, k)), \
        f"knn_topk integer case {(m, n, d, k)} differs"


def knn_against_plain(knn_k, test, train, labels, k, cuda, far=False) -> float:
    """Two launches bitwise equal; distances within rtol 1e-5 / atol 1e-3
    of the plain version's, labels equal wherever the order is not
    decided by a near-tie: neighbours whose distances lie within 1e-3,
    or with ``far`` (data far from the origin, where the fp32 rounding of
    |x|^2 and |y|^2 alone passes 1e-3) within twice the distance
    tolerance.  Returns the largest error."""
    m, n = test.shape[0], train.shape[0]
    got = knn_k.knn_topk_cuda(test, train, labels, k)
    again = knn_k.knn_topk_cuda(test, train, labels, k)
    assert bitwise_equal(got, again), "knn_topk: two launches differ"
    kk = min(k + 1, n)
    want_d, want_l = knn_k.knn_topk_plain(test, train, labels, kk)
    torch.testing.assert_close(got[0], want_d[:, :k], rtol=1e-5, atol=1e-3)
    # labels must agree wherever the order is not decided by a near-tie
    gap = want_d[:, 1:] - want_d[:, :-1]                     # (m, kk-1)
    tie = 2 * (1e-3 + 1e-5 * want_d[:, 1:].abs()) if far else 1e-3
    sep = torch.ones((m, kk + 1), dtype=torch.bool, device=cuda)
    sep[:, 1:kk] = gap > tie        # sep[:, i]: clear gap before position i
    isolated = sep[:, :k] & sep[:, 1:k + 1]
    assert torch.equal(got[1][isolated], want_l[:, :k][isolated]), \
        "knn_topk labels differ away from near-ties"
    return (got[0] - want_d[:, :k]).abs().max().item()


def knn_against_float64(knn_k, test, train, labels, k, cuda) -> tuple:
    """For data far from the origin, where fp32's own rounding of |x|^2,
    x.y and |y|^2 passes the atol 1e-3 that knn_against_plain holds two
    fp32 results to (on an H100 the plain fp32 version lay 1.6e-3 off the
    float64 distances at d 64, |x| ~ 40): two launches bitwise equal;
    the distances no further from the plain version's in float64 than
    the plain fp32 version's are; labels equal to the float64 version's
    away from near-ties, pairs closer than twice the larger of the
    kernel's error and knn_against_plain's ``far`` rule.  Returns (the
    kernel's largest distance error, the plain fp32 version's)."""
    m, n = test.shape[0], train.shape[0]
    got = knn_k.knn_topk_cuda(test, train, labels, k)
    assert bitwise_equal(got, knn_k.knn_topk_cuda(test, train, labels, k)), \
        "knn_topk: two launches differ"
    kk = min(k + 1, n)
    want_d, want_l = knn_k.knn_topk_plain(test.double(), train.double(), labels, kk)
    plain_d = knn_k.knn_topk_plain(test, train, labels, k)[0]
    err = (got[0].double() - want_d[:, :k]).abs().max().item()
    plain_err = (plain_d.double() - want_d[:, :k]).abs().max().item()
    assert err <= plain_err, f"knn_topk {err} off the float64 distances, the plain fp32 {plain_err}"
    gap = want_d[:, 1:] - want_d[:, :-1]
    sep = torch.ones((m, kk + 1), dtype=torch.bool, device=cuda)
    sep[:, 1:kk] = gap > 2 * torch.clamp(1e-3 + 1e-5 * want_d[:, 1:].abs(), min=err)
    isolated = sep[:, :k] & sep[:, 1:k + 1]
    assert torch.equal(got[1][isolated], want_l[:, :k][isolated]), \
        "knn_topk labels differ away from near-ties"
    return err, plain_err


def check_knn(knn_k, gen, cuda):
    """knn_topk kernel vs its plain version; returns the kernels-line row."""
    def exact_case(m, n, d, k, **ties):
        knn_exact_case(knn_k, gen, cuda, m, n, d, k, **ties)

    # k past the register lists (the wide route), ties and all
    for k in (1, 5, 16, 32, 33, 100, 257):
        exact_case(300, 1000, 50, k)
    # d past the tile's shared memory: the wide route
    for d, k in ((273, 5), (1024, 40), (1024, 257)):
        exact_case(150, 700, d, k, dup=200, same=50)
    exact_case(70, 9000, 7, 1000)               # lists in global scratch
    exact_case(40, 300, 5, 300)                 # k = n

    def normal_case(m, n, d, k):
        test = torch.from_numpy(gen.standard_normal((m, d)).astype(np.float32)).to(cuda)
        train = torch.from_numpy(gen.standard_normal((n, d)).astype(np.float32)).to(cuda)
        labels = torch.from_numpy(gen.integers(0, 4, size=n).astype(np.int32)).to(cuda)
        return test, train, labels, knn_against_plain(knn_k, test, train, labels, k, cuda)

    normal_case(1037, 10013, 50, 5)             # ragged m and n
    normal_case(129, 3, 50, 3)                  # k > fragment rows: the caller passes n
    normal_case(77, 5000, 13, 20)               # d not a multiple of 4, K=32 list
    normal_case(300, 9000, 20, 100)             # the wide route: k past the lists,
    normal_case(200, 3000, 300, 5)              # d past the tile,
    normal_case(70, 9000, 7, 1000)              # lists in global scratch
    # the narrow route at its edge (d 64, k 32) on points ~40 from the origin
    from repro_torch.algorithms.kmeans import _np_fill_fragment
    m, n, d, k = 2000, 100_000, 64, 32
    pts = torch.from_numpy(_np_fill_fragment(SEED, m + n, d).astype(np.float32)).to(cuda)
    labels = torch.from_numpy(gen.integers(0, 4, size=n).astype(np.int32)).to(cuda)
    assert knn_k.route(k, d) == "tensor_cores"
    err, plain_err = knn_against_float64(knn_k, pts[:m].contiguous(), pts[m:].contiguous(),
                                         labels, k, cuda)
    far_case = {"shape": {"m": m, "n": n, "d": d, "k": k}, "max_abs_err_float64": err,
                "plain_max_abs_err_float64": plain_err}

    def timed(m, n, d, k, parent=False):
        exact_case(m, n, d, k)
        test, train, labels, err = normal_case(m, n, d, k)
        def run():
            return times(lambda: knn_k.knn_topk_cuda(test, train, labels, k),
                         lambda: knn_k.knn_topk_plain(test, train, labels, k), reps=10,
                         plain_reps=3)

        t = with_parent("knn_topk", lambda mod: mod.knn_topk_cuda(test, train, labels, k), run) \
            if parent else run()
        nbytes = 4.0 * (m * d + n * d + n) + 8.0 * m * k
        fp32_cores = bound(2.0 * m * n * d, nbytes)
        # both routes: three TF32 products per pair on the tensor cores
        bound_ms, bound_by = bound(3 * 2.0 * m * n * d, nbytes, PEAK_TF32_FLOPS)
        return {"shape": {"m": m, "n": n, "d": d, "k": k}, "cuda_route": knn_k.route(k, d),
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_fp32_cores": fp32_cores[0]}

    # the path shape: one KNN_frag task of phase 4, on the tensor cores
    row = timed(12_500, 125_000, 50, 5, parent=True)
    assert row["cuda_route"] == "tensor_cores", row["cuda_route"]
    row["wide_shapes"] = [timed(12_500, 125_000, 50, 33), timed(12_500, 125_000, 300, 5)]
    assert all(w["cuda_route"] == "wide" for w in row["wide_shapes"])
    # the routes' edges, each pair timed in this run: k 32 | 33 at d 50, d 64 | 65 at
    # k 5; and d 272 | 273, the edge of the tensor-core route's shared memory
    row["edge_pairs"] = [[timed(12_500, 125_000, 50, 32, parent=True), row["wide_shapes"][0]],
                         [timed(12_500, 125_000, 64, 5, parent=True),
                          timed(12_500, 125_000, 65, 5)],
                         [timed(12_500, 125_000, 272, 5), timed(12_500, 125_000, 273, 5)]]
    assert [[w["cuda_route"] for w in pair] for pair in row["edge_pairs"]] == \
        [["tensor_cores", "wide"]] * 2 + [["wide", "wide"]]
    row["far_case"] = far_case
    return {"name": "knn_topk", "route": "cuda",
            "source": "src/repro_torch/csrc/knn_topk.cu",
            "replaces": "src/repro/kernels/knn_topk.py:86", **row}


def kmeans_exact_case(km_k, gen, cuda, n, d, k, sse_exact=True) -> None:
    """Integer-valued inputs: dot products, |c|^2/2, sums and sse are
    exact; half-integer scores make argmax ties common.  Two launches
    bitwise equal and bitwise the plain version's result.  Where the sse
    is far past 2^24 (|x - c|^2 ~ 200 a point at d 50) fp32 sums of
    integers round by their order: there (``sse_exact`` False) the sse
    is held to rtol 1e-6."""
    def ints(shape):
        return torch.from_numpy(gen.integers(-2, 3, size=shape).astype(np.float32)).to(cuda)

    x, c = ints((n, d)), ints((k, d))
    got = km_k.kmeans_assign_cuda(x, c)
    assert bitwise_equal(got, km_k.kmeans_assign_cuda(x, c)), \
        f"kmeans_assign: two launches differ on integer inputs {(n, d, k)}"
    want = km_k.kmeans_assign_plain(x, c)
    exact = 3 if sse_exact else 2
    assert bitwise_equal(got[:exact], want[:exact]), \
        f"kmeans_assign integer case {(n, d, k)} differs"
    if not sse_exact:
        torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0.0)


def kmeans_against_plain(km_k, x, c, far=False) -> tuple:
    """The points whose two best centroids score within 1e-4 dropped
    (there the fp32 rounding of two dot-product orders may decide), or
    with ``far`` (data far from the origin, where the scores' rounding
    passes 1e-4) within 1e-4 + 1e-5 |x| max|c|.
    Then two launches bitwise equal, counts equal to the plain version's,
    sums and sse within rtol 1e-5.  Returns (x kept, largest sums error,
    the sse's relative error)."""
    half = x @ c.T - 0.5 * (c * c).sum(1)[None, :]
    top2 = half.topk(2, dim=1).values
    tie = 1e-4 + 1e-5 * x.norm(dim=1) * c.norm(dim=1).max() if far else 1e-4
    x = x[(top2[:, 0] - top2[:, 1]) >= tie].contiguous()
    got = km_k.kmeans_assign_cuda(x, c)
    again = km_k.kmeans_assign_cuda(x, c)
    assert bitwise_equal(got, again), "kmeans_assign: two launches differ"
    sums, counts, sse = km_k.kmeans_assign_plain(x, c)
    assert torch.equal(got[1], counts), "kmeans_assign counts differ"
    torch.testing.assert_close(got[0], sums, rtol=1e-5,
                               atol=1e-5 * sums.abs().max().item())
    torch.testing.assert_close(got[2], sse, rtol=1e-5, atol=0.0)
    return x, (got[0] - sums).abs().max().item(), abs(got[2].item() / sse.item() - 1.0)


def check_kmeans(km_k, gen, cuda):
    """kmeans_assign kernel vs its plain version; returns the kernels-line row."""
    def exact_case(n, d, k, sse_exact=True):
        kmeans_exact_case(km_k, gen, cuda, n, d, k, sse_exact)

    # the last four past the tensor-core route: the wide route
    for n, d, k in ((5000, 50, 16), (1001, 13, 5), (5000, 50, 65), (3001, 257, 16),
                    (20_000, 300, 1000), (7000, 384, 100)):
        exact_case(n, d, k)

    def normal_case(n, d, k):
        x = torch.from_numpy(gen.standard_normal((n, d)).astype(np.float32)).to(cuda)
        c = torch.from_numpy(gen.standard_normal((k, d)).astype(np.float32)).to(cuda)
        x, err, _ = kmeans_against_plain(km_k, x, c)
        return x, c, err

    normal_case(1007, 13, 5)                    # ragged tile, k not a multiple of 4
    normal_case(100_003, 50, 16)
    normal_case(20_011, 300, 1000)              # the wide route, both past
    # the narrow route on run_kmeans's own fills at its widest (d 256, k 64):
    # points ~80 from the origin, centroids drawn from them plus 0.3 N(0, 1)
    from repro_torch.algorithms.kmeans import _np_fill_fragment
    n, d, k = 100_000, 256, 64
    pts = _np_fill_fragment(SEED, n, d).astype(np.float32)
    cents = pts[gen.choice(n, k, replace=False)] + 0.3 * gen.standard_normal((k, d))
    x = torch.from_numpy(pts).to(cuda)
    c = torch.from_numpy(cents.astype(np.float32)).to(cuda)
    assert km_k.route(k, d) == "tensor_cores"
    kept, far_err, far_sse = kmeans_against_plain(km_k, x, c, far=True)
    far_case = {"shape": {"n": kept.shape[0], "d": d, "k": k}, "max_abs_err": far_err,
                "sse_rel_err": far_sse}

    def timed(n, d, k, parent=False):
        exact_case(10_000, d, k)              # sse below 2^24
        exact_case(n, d, k, sse_exact=False)
        x, c, err = normal_case(n, d, k)
        n = x.shape[0]
        def run():
            return times(lambda: km_k.kmeans_assign_cuda(x, c),
                         lambda: km_k.kmeans_assign_plain(x, c))

        t = with_parent("kmeans_assign", lambda m: m.kmeans_assign_cuda(x, c), run) \
            if parent else run()
        nbytes = 4.0 * (n * d + 2 * k * d + k + 1)
        # both routes: three TF32 products per score on the tensor cores
        bound_ms, bound_by = bound(3 * 2.0 * n * k * d, nbytes, PEAK_TF32_FLOPS)
        return {"shape": {"n": n, "d": d, "k": k}, "cuda_route": km_k.route(k, d),
                "max_abs_err": err, **t, "bound_ms": bound_ms, "bound_by": bound_by,
                "bound_ms_fp32_cores": bound(2.0 * n * k * d + 3.0 * n * d, nbytes)[0]}

    # the path shape: one partial_sum task of phase 5, on the tensor cores
    row = timed(500_000, 50, 16, parent=True)
    assert row["cuda_route"] == "tensor_cores", row["cuda_route"]
    row["wide_shapes"] = [timed(500_000, 50, 65), timed(100_000, 257, 16)]
    assert all(w["cuda_route"] == "wide" for w in row["wide_shapes"])
    # the routes' edges, each pair timed in this run: k 64 | 65 at d 50, d 256 | 257 at k 16
    row["edge_pairs"] = [[timed(500_000, 50, 64, parent=True), row["wide_shapes"][0]],
                         [timed(100_000, 256, 16, parent=True), row["wide_shapes"][1]]]
    assert [[w["cuda_route"] for w in pair] for pair in row["edge_pairs"]] == \
        [["tensor_cores", "wide"]] * 2
    row["far_case"] = far_case
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

    row = at_shape(8, 16, 8, 512, 64, None)      # every layer's prefill in phase 10
    # every local_attn layer's prefill in phase 12 (recurrentgemma-9b)
    row["hybrid_shape"] = at_shape(8, 16, 1, 512, 256, 2048)
    # every layer's prefill in phase 13 and forward in phase 17
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
    # the path shape: every rglru layer's prefill in phase 12 (fp32 gates)
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
    # the path shape: every layer's prefill in phase 11 (mamba2-780m)
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


# phase wide: the two pipelines at sentence-embedding width, past both
# routes' tensor-core limits (k > 32 and d > 64; k > 64 and d > 256)
WIDE_KNN = dict(n_train=500_000, n_test=20_000, d=384, k=50, n_classes=4, train_fragments=16,
                test_blocks=4)
WIDE_KMEANS = dict(n_points=1_000_000, d=384, k=100, fragments=16, max_iters=5, tol=0.0)


def wide_phase(ph, ops, knn, kmeans, api, knn_k, km_k, make_blobs, cuda) -> dict:
    """run_knn and run_kmeans at embedding width on the card, held as
    phases knn and kmeans hold theirs; returns the runs' launch counts.
    Then one KNN_frag and one partial_sum at the runs' shapes, each held
    against its plain version and timed (those launches are not counted)."""
    kc, mc = WIDE_KNN, WIDE_KMEANS
    assert knn_k.route(kc["k"], kc["d"]) == "wide" and km_k.route(mc["k"], mc["d"]) == "wide"
    ops.reset_launch_counts()
    with api.runtime_start(n_workers=4, backend="thread") as rt:
        t0 = time.perf_counter()
        res = knn.run_knn(**kc, seed=SEED, device=cuda)
        torch.cuda.synchronize()
        knn_wall = time.perf_counter() - t0
    knn_counts = ops.launch_counts()
    assert knn_counts == only(ops, knn_topk=kc["train_fragments"] * kc["test_blocks"]), knn_counts
    preds = res.predictions
    assert preds.shape == (kc["n_test"],) and preds.min() >= 0 and preds.max() < kc["n_classes"]
    agree = knn_oracle_agreement(knn, knn_k, make_blobs, preds, cuda, **kc)
    assert agree >= 999, f"only {agree}/1000 wide predictions agree with the fp64 oracle"

    ops.reset_launch_counts()
    walls = []
    runs = []
    for _ in range(2):
        with api.runtime_start(n_workers=4, backend="thread"):
            t0 = time.perf_counter()
            runs.append(kmeans.run_kmeans(**mc, seed=SEED, device=cuda))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    km_counts = ops.launch_counts()
    r1, r2 = runs
    assert km_counts == only(ops, kmeans_assign=mc["fragments"] * (r1.iterations + r2.iterations)), \
        km_counts
    assert r1.iterations == mc["max_iters"] and r1.centroids.shape == (mc["k"], mc["d"])
    assert np.isfinite(r1.centroids).all()
    hist = r1.sse_history
    assert len(hist) == mc["max_iters"] and all(np.isfinite(hist))
    for a, b in zip(hist, hist[1:]):
        assert b <= a * (1 + 1e-6), f"wide SSE rose from {a} to {b}"
    assert r1.centroids.tobytes() == r2.centroids.tobytes(), \
        "two wide K-means runs gave different centroids"
    counts = {k: knn_counts[k] + km_counts[k] for k in ops.KERNELS}

    # one task of each at the runs' shapes, held against its plain version
    # on the runs' data and on tied integers, then timed; apart from the counts
    gen = np.random.default_rng(SEED)
    m = kc["n_test"] // kc["test_blocks"]
    n = kc["n_train"] // kc["train_fragments"]
    test = torch.from_numpy(make_blobs(10_000 + SEED, m, kc["d"], kc["n_classes"])[0]
                            .astype(np.float32)).to(cuda)
    X, y = make_blobs(SEED, n, kc["d"], kc["n_classes"])
    train = torch.from_numpy(X.astype(np.float32)).to(cuda)
    labels = torch.from_numpy(y.astype(np.int32)).to(cuda)
    frag_err = knn_against_plain(knn_k, test, train, labels, kc["k"], cuda, far=True)
    knn_exact_case(knn_k, gen, cuda, m, n, kc["d"], kc["k"])
    frag_ms = device_ms(lambda: knn_k.knn_topk_cuda(test, train, labels, kc["k"]), reps=5)
    pts = torch.from_numpy(kmeans._np_fill_fragment(SEED, mc["n_points"] // mc["fragments"],
                                                    mc["d"]).astype(np.float32)).to(cuda)
    cents = torch.from_numpy(r1.centroids.astype(np.float32)).to(cuda)
    kept, psum_err, _ = kmeans_against_plain(km_k, pts, cents, far=True)
    kmeans_exact_case(km_k, gen, cuda, 8000, mc["d"], mc["k"])          # sse below 2^24
    kmeans_exact_case(km_k, gen, cuda, pts.shape[0], mc["d"], mc["k"], sse_exact=False)
    psum_ms = device_ms(lambda: km_k.kmeans_assign_cuda(pts, cents), reps=10)
    ph.info.update(knn_wall_s=knn_wall, knn_tasks=res.n_tasks, oracle_agree=agree,
                   kmeans_walls_s=walls, kmeans_iterations=r1.iterations, sse_history=hist,
                   launches=counts,
                   knn_frag={"shape": {"m": m, "n": n, "d": kc["d"], "k": kc["k"]},
                             "device_ms": frag_ms, "max_abs_err": frag_err},
                   partial_sum={"shape": {"n": pts.shape[0], "d": mc["d"], "k": mc["k"]},
                                "device_ms": psum_ms, "max_abs_err": psum_err,
                                "points_held": kept.shape[0]})
    return counts


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

    def forced(xf, w_router, top_k, renormalize=True, group=None):
        _, _, aux = route(xf, w_router, top_k, renormalize, group=group)
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


MESH_STEPS, MESH_CKPT = 4, 3       # phase mesh: train steps, the step restored from


def nvidia_smi() -> str:
    """nvidia-smi's name and power limit of the card, read now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def mesh_phase(ph, ops, lm, train, serve, cfg, cuda, served_tokens) -> dict:
    """Phase mesh: the multi-device layer on one card (see the module
    docstring).  Fills ``ph.info`` and returns the phase's launch counts."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=cuda)
    ckpt = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="chip_smoke_mesh_")
    ckpt_plain = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="chip_smoke_plain_")
    try:
        mesh = make_local_mesh()
        assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1, 1), mesh
        kw = dict(steps=MESH_STEPS, batch=BATCH, seq=PROMPT_LEN, lr=1e-3, warmup=2, seed=SEED,
                  log_every=0, device=cuda)
        ops.reset_launch_counts()
        meshed = train.train_loop(cfg, mesh=mesh, ckpt_dir=ckpt, ckpt_every=MESH_CKPT, **kw)
        counts = ops.launch_counts()
        per_step = train_launches(ops, cfg)
        assert counts == {k: MESH_STEPS * n for k, n in per_step.items()}, (counts, per_step)
        torch.cuda.empty_cache()
        # the same checkpoints as the mesh run, so that the two runs' times
        # hold the same work
        plain = train.train_loop(cfg, ckpt_dir=ckpt_plain, ckpt_every=MESH_CKPT, **kw)
        shutil.rmtree(ckpt_plain, ignore_errors=True)
        torch.cuda.empty_cache()
        assert len(meshed["losses"]) == MESH_STEPS and np.isfinite(meshed["losses"]).all()
        assert meshed["losses"] == plain["losses"], \
            ("the mesh's losses are not the one-device losses", meshed["losses"], plain["losses"])
        # a launch on the mesh restored from the step-3 checkpoint (other
        # weights to start from) runs the last step
        shutil.rmtree(os.path.join(ckpt, f"step_{MESH_STEPS:08d}"))
        resumed = train.train_loop(cfg, mesh=mesh, ckpt_dir=ckpt, restore=True,
                                   model=lm.init_params(cfg, seed=SEED + 1, device=cuda), **kw)
        assert resumed["restored_from"] == MESH_CKPT, resumed["restored_from"]
        np.testing.assert_allclose(resumed["losses"], plain["losses"][MESH_CKPT:], rtol=1e-5,
                                   err_msg="resumed on the mesh vs uninterrupted losses")
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        out = serve.serve_batch(cfg, batch=BATCH, prompt_len=PROMPT_LEN, gen_len=GEN_LEN,
                                seed=SEED, device=cuda, mesh=mesh)
        serve_counts = ops.launch_counts()
        want = only(ops, rmsnorm=GEN_LEN * (cfg.n_layers * 4 + 1), flash_attention=cfg.n_layers)
        assert serve_counts == want, (serve_counts, want)
        assert np.array_equal(out["tokens"], served_tokens), "the mesh served other tokens"
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(ckpt_plain, ignore_errors=True)
        dist.destroy_process_group()
    assert not dist.is_initialized()

    def run(r):
        steady = float(np.median(r["step_seconds"][1:]))
        return {"step_seconds": r["step_seconds"], "steady_step_s": steady,
                "steady_tokens_per_s": BATCH * PROMPT_LEN / steady,
                "steps_tokens_per_s": MESH_STEPS * BATCH * PROMPT_LEN / sum(r["step_seconds"]),
                "tokens_per_s": r["tokens_per_s"]}

    ph.info.update(arch=cfg.name, steps=MESH_STEPS, batch=BATCH, seq=PROMPT_LEN,
                   losses=meshed["losses"], resumed_losses=resumed["losses"],
                   launches_train=counts, launches_serve=serve_counts,
                   mesh_run=run(meshed), plain_run=run(plain),
                   serve={k: out[k] for k in ("prefill_s", "decode_s", "decode_tokens_per_s")})
    emit({"mesh": {"meshed": run(meshed), "plain": run(plain)}, "nvidia_smi": nvidia_smi()})
    return {k: counts[k] + serve_counts[k] for k in counts}


# phase tp_ep
TP_EP_TRAIN = (("granite-3-2b", 4), ("deepseek-moe-16b", 2))   # part (b): (arch, layers kept)
TP_EP_STEPS = 4
TP_EP_RANKS = 2
# part (b): the losses of two TP ranks sharing the card against one
# rank's, bf16 at full width.  The sliced products round their partial
# sums to bf16 before the all-reduce adds them, so the two runs differ
# by bf16 rounding from the first step on, and AdamW's first updates
# (about lr · sign(g)) move noise-level gradient elements either way;
# deepseek's router then picks some near-tied experts apart.  Summed over
# 4096 tokens a step, that moves the loss by far less than this limit,
# while a wrong sum (a partial counted twice or left out) moves it by
# whole units: the readings are in PERF.md.
TP_EP_LOSS_ATOL = 0.02
# part (a): at one rank each sublayer computes its plain layers' ops on
# whole slices, so its gradients should be the layers' bit for bit; held
# within two bf16 steps of each leaf's largest magnitude
TP_GRAD_STEPS = 2.0
TP_EP_TIMEOUT = 900.0


def sublayer_grads(fn, x, cot, params) -> tuple:
    """(out, x's gradient, {name: gradient}) of ``fn(x)`` under the
    cotangent ``cot``."""
    for p in params.values():
        p.grad = None
    xi = x.detach().clone().requires_grad_()
    out = fn(xi)
    out.backward(cot)
    grads = {n: p.grad.clone() for n, p in params.items() if p.grad is not None}
    for p in params.values():
        p.grad = None
    return out.detach(), xi.grad, grads


def max_err_in_steps(got, want) -> float:
    """The largest |got - want| in bf16 steps of want's largest magnitude."""
    scale = float(want.abs().max().float())
    return float((got.float() - want.float()).abs().max()) / (scale * BF16_STEP) if scale else 0.0


def tp_ep_rank(rank: int, world: int, store: str, out_dir: str, jobs) -> None:
    """One rank of part (b): ``train_loop(mesh=)`` of each job on a
    (1, ``world``) mesh of gloo ranks that share the one card; saves its
    losses, step seconds and launch counts (or its traceback)."""
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        sys.path.insert(0, os.path.join(ROOT, "src"))
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.configs import get_config
        from repro_torch.kernels import ops
        from repro_torch.launch import train
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cuda = torch.device("cuda", 0)
        torch.cuda.set_device(cuda)
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        out = {}
        try:
            mesh = DeviceMesh("cuda", torch.arange(world).reshape(1, world),
                              mesh_dim_names=("data", "model"))
            for arch, layers in jobs:
                cfg = dataclasses.replace(get_config(arch), n_layers=layers,
                                          tp_block="shard_map")
                ops.reset_launch_counts()
                run = train.train_loop(cfg, mesh=mesh, steps=TP_EP_STEPS, batch=BATCH,
                                       seq=PROMPT_LEN, lr=1e-3, warmup=2, seed=SEED,
                                       log_every=0, device=cuda)
                out[arch] = {"losses": run["losses"], "aux": run["aux"],
                             "step_seconds": run["step_seconds"],
                             "launches": ops.launch_counts(),
                             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
        torch.save({"ok": out}, path)
    except BaseException:
        import traceback
        torch.save({"error": traceback.format_exc()}, path)
        raise


def tp_ep_ranks(jobs) -> list:
    """Part (b)'s ranks, spawned, and their results by rank; the first
    failing rank's traceback raises."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    out_dir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"), prefix="chip_smoke_tp_ep_")
    try:
        procs = [ctx.Process(target=tp_ep_rank,
                             args=(r, TP_EP_RANKS, os.path.join(out_dir, "store"), out_dir, jobs))
                 for r in range(TP_EP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TP_EP_TIMEOUT
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pt")
            got = torch.load(path, weights_only=False) if os.path.exists(path) else None
            if got is None or "error" in got:
                raise RuntimeError(f"tp_ep rank {r} failed (exit {p.exitcode}):\n"
                                   f"{got['error'] if got else 'no result'}")
            results.append(got["ok"])
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


CODEC_SIZES = (1024, 4096, 8192)   # phase codecs: Table 1's square float64 blocks
CODEC_REPEATS = 3


def codecs_phase(ph, serialization, cuda, smi: str) -> None:
    """The paper's Table 1 on the card's host: the port's
    ``benchmark_codecs`` (best serialize and deserialize seconds of
    CODEC_REPEATS per codec and block size, the file-backed ``mmap`` codec
    among them), each beside the port's own crossing of an address-space
    boundary for that block: a card tensor goes device -> host (``.cpu()``)
    before any codec touches it, and comes back by an upload, each timed
    between two synchronisations.  Every codec holds every size, every
    time is finite and positive, and the 1024 block goes through each
    codec, the mmap file and a spill bitwise."""
    table = serialization.benchmark_codecs(sizes=CODEC_SIZES, dtype=np.float64,
                                           repeats=CODEC_REPEATS)
    assert list(table) == [*serialization.CODECS, "mmap"], list(table)
    rng = np.random.default_rng(0)          # benchmark_codecs' blocks, in its order
    crossing = {}
    for size in CODEC_SIZES:
        host = torch.from_numpy(rng.standard_normal((size, size)).astype(np.float64))
        dev = host.to(cuda)
        to_host = to_card = float("inf")
        for _ in range(CODEC_REPEATS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = dev.cpu()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            back = got.to(cuda)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            to_host, to_card = min(to_host, t1 - t0), min(to_card, t2 - t1)
        assert torch.equal(got, host) and torch.equal(back, dev), size
        crossing[size] = (to_host, to_card)
        del host, dev, got, back
    torch.cuda.empty_cache()
    for name, per_size in table.items():
        assert list(per_size) == list(CODEC_SIZES), (name, list(per_size))
        for size, (s_sec, d_sec) in per_size.items():
            assert np.isfinite([s_sec, d_sec]).all() and s_sec > 0 and d_sec > 0, \
                (name, size, s_sec, d_sec)
            emit({"codec": name, "size": size, "dtype": "float64", "s_seconds": s_sec,
                  "d_seconds": d_sec, "card_to_host_seconds": crossing[size][0],
                  "host_to_card_seconds": crossing[size][1], "nvidia_smi": smi})
    block = np.random.default_rng(SEED).standard_normal((1024, 1024))
    for name in serialization.CODECS:
        out = np.asarray(serialization.deserialize(serialization.serialize(block, name), name))
        assert out.dtype == block.dtype and out.tobytes() == block.tobytes(), name
    mc = serialization.MmapCodec()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_codecs_") as tmp:
        path = os.path.join(tmp, "block.rjx")
        mc.ser_to_file(block, path)
        view = mc.de_from_file(path)
        assert np.asarray(view).tobytes() == block.tobytes(), "mmap"
        spilled = mc.spill(block, dir=tmp)
        assert np.asarray(spilled).tobytes() == block.tobytes(), "spill"
        del view, spilled
        gc.collect()
        assert os.listdir(tmp) == ["block.rjx"], os.listdir(tmp)
    ph.info.update(sizes=list(CODEC_SIZES), dtype="float64", repeats=CODEC_REPEATS,
                   table={name: {str(size): list(t) for size, t in per_size.items()}
                          for name, per_size in table.items()},
                   crossing={str(size): list(t) for size, t in crossing.items()},
                   nvidia_smi=smi)


def tp_ep_phase(ph, ops, lm, train, get_config, cuda) -> dict:
    """Phase tp_ep: the TP sublayers and the expert-parallel MoE at full
    width, (a) at world size 1 against the plain layers and (b) on two
    gloo ranks sharing the card against one rank (see the module
    docstring).  Fills ``ph.info`` and returns the phase's launch counts:
    part (a)'s sublayer calls and both ranks' training."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.layers import moe, tp_block
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(cuda)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=cuda)
    bf16 = torch.bfloat16
    try:
        mesh = make_local_mesh()
        group, data_group = mesh.get_group("model"), mesh.get_group("data")
        gen = torch.Generator(device=cuda)
        gen.manual_seed(SEED)

        def block(cfg, btype):
            blk = lm.Block(cfg, btype, device=cuda)
            blk.init_weights(gen)
            with torch.no_grad():          # norm scales off their ones
                for n, p in blk.named_parameters():
                    if n.endswith("scale"):
                        p.add_(0.1 * torch.randn(p.shape, generator=gen, device=cuda).to(p.dtype))
            return blk

        def rand(*shape):
            return torch.randn(shape, generator=gen, device=cuda).to(bf16)

        granite, rg = get_config("granite-3-2b"), get_config("recurrentgemma-9b")
        g_blk, r_rec, r_att = block(granite, "dense"), block(rg, "rglru"), block(rg, "local_attn")
        xg, xr = rand(BATCH, PROMPT_LEN, granite.d_model), rand(BATCH, PROMPT_LEN, rg.d_model)
        cg, cr = rand(*xg.shape), rand(*xr.shape)
        w = rg.local_window
        # (name, block, x, cotangent, the TP sublayer, the plain layers it slices)
        cases = [
            ("granite_attn", g_blk, xg, cg,
             lambda x: tp_block.tp_attn_sublayer(g_blk.ln1, g_blk.attn, x, cfg=granite,
                                                 group=group),
             lambda x: x + g_blk.attn(g_blk.ln1(x))[0]),
            ("granite_mlp", g_blk, xg, cg,
             lambda x: tp_block.tp_mlp_sublayer(g_blk.ln2, g_blk.mlp, x, group=group),
             lambda x: x + g_blk.mlp(g_blk.ln2(x))),
            ("recurrentgemma_rglru", r_rec, xr, cr,
             lambda x: tp_block.tp_rglru_sublayer(r_rec.ln1, r_rec.rec, x, group=group),
             lambda x: x + r_rec.rec(r_rec.ln1(x))[0]),
            ("recurrentgemma_local_attn", r_att, xr, cr,
             lambda x: tp_block.tp_attn_sublayer(r_att.ln1, r_att.attn, x, cfg=rg, group=group,
                                                 window=w),
             lambda x: x + r_att.attn(r_att.ln1(x), window=w)[0]),
        ]
        ds = get_config("deepseek-moe-16b")
        experts = moe.MoE(ds.d_model, ds.d_ff_expert, ds.n_experts, dtype=bf16, device=cuda)
        experts.init_weights(gen)
        h = rand(BATCH, PROMPT_LEN, ds.d_model)
        kw = dict(top_k=ds.top_k, capacity_factor=ds.moe_capacity_factor,
                  renormalize=ds.moe_renormalize)

        def sharded():
            with torch.no_grad():
                return moe.moe_apply_sharded(experts.params(), h, model_group=group,
                                             data_group=data_group, **kw)

        # the kernels at the shapes the TP path gives them on two and four
        # model ranks, against their plain versions (not counted): flash
        # with a rank's q heads per kv group (granite 16 / 4, deepseek
        # 8 / 8) and after recurrentgemma's replicated-K/V gather (8 and 4
        # heads, d 256, window 2048); rglru_scan on half of its 4096 width
        from repro_torch.kernels import flash_attention as fa_k
        from repro_torch.kernels import rglru_scan as rg_k
        sliced = {}
        for name, (H, K, d, window) in {"granite_tp2": (16, 4, 64, None),
                                        "deepseek_tp2": (8, 8, 128, None),
                                        "recurrentgemma_tp2_gathered": (8, 8, 256, w),
                                        "recurrentgemma_tp4_gathered": (4, 4, 256, w)}.items():
            q, k, v = (rand(BATCH, PROMPT_LEN, n, d).transpose(1, 2) for n in (H, K, K))
            sliced[name] = close_in_dtype(
                fa_k.flash_attention_cuda(q, k, v, causal=True, window=window),
                fa_k.flash_attention_plain(q, k, v, causal=True, window=window), name)
        la = -torch.nn.functional.softplus(
            torch.randn((BATCH, PROMPT_LEN, rg.rnn_width // 2), generator=gen, device=cuda))
        b = torch.randn(la.shape, generator=gen, device=cuda)
        y, h_last = rg_k.rglru_scan_cuda(la, b)
        want_y, want_h = rg_k.rglru_scan_plain(la, b)
        sliced["rglru_half_width"] = close_in_dtype(y, want_y, "rglru_scan at R/2")
        close_in_dtype(h_last, want_h, "rglru_scan h_T at R/2")
        del q, k, v, la, b, y, h_last, want_y, want_h

        # the path: every TP sublayer's forward and backward, and the
        # expert-parallel MoE twice, counted
        ops.reset_launch_counts()
        tp_runs = {name: sublayer_grads(tp, x, c, dict(blk.named_parameters()))
                   for name, blk, x, c, tp, _ in cases}
        ep_runs = [sharded(), sharded()]
        counts_a = ops.launch_counts()
        want_a = only(ops, rmsnorm=4, flash_attention=2, rglru_scan=1)
        assert counts_a == want_a, (counts_a, want_a)

        report = {}
        for name, blk, x, c, tp, plain in cases:
            params = dict(blk.named_parameters())
            out, gx, grads = tp_runs[name]
            p_out, p_gx, p_grads = sublayer_grads(plain, x, c, params)
            assert torch.isfinite(out.float()).all(), name
            assert torch.equal(out, p_out), f"{name}: the sublayer's output is not the layer's"
            errs = {"x": max_err_in_steps(gx, p_gx)}
            assert set(grads) == set(p_grads), (name, set(grads) ^ set(p_grads))
            errs.update({n: max_err_in_steps(grads[n], g) for n, g in p_grads.items()})
            worst = max(errs, key=errs.get)
            assert errs[worst] <= TP_GRAD_STEPS, (name, worst, errs[worst])
            with torch.no_grad():          # in turns: plain, TP, TP, plain
                t = [event_ms(lambda: f(x)) for f in (plain, tp, tp, plain)]
            report[name] = {"grad_err_bf16_steps": errs[worst], "worst_leaf": worst,
                            "event_ms": t[1:3], "plain_event_ms": [t[0], t[3]]}
        (out1, aux1), (out2, aux2) = ep_runs
        with torch.no_grad():
            out_l, aux_l = moe.moe_apply_local(experts.params(), h, **kw)
        assert torch.equal(out1, out2) and torch.equal(aux1, aux2), "EP forward not repeatable"
        assert torch.equal(out1, out_l) and torch.equal(aux1, aux_l), \
            "the expert-parallel MoE at one rank is not moe_apply_local"
        with torch.no_grad():
            def local():
                return moe.moe_apply_local(experts.params(), h, **kw)
            t = [event_ms(f) for f in (local, sharded, sharded, local)]
        report["deepseek_moe"] = {"event_ms": t[1:3], "plain_event_ms": [t[0], t[3]],
                                  "aux": float(aux1)}
        del g_blk, r_rec, r_att, experts, tp_runs, ep_runs, cases
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
    torch.cuda.empty_cache()
    ph.info.update(sublayers=report, sliced_kernel_max_abs_err=sliced, launches_a=counts_a)
    emit({"tp_ep_sublayers": report, "nvidia_smi": nvidia_smi()})

    # part (b): world size 1 first, then the two ranks
    plain_runs = {}
    for arch, layers in TP_EP_TRAIN:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        plain_runs[arch] = train.train_loop(cfg, steps=TP_EP_STEPS, batch=BATCH, seq=PROMPT_LEN,
                                            lr=1e-3, warmup=2, seed=SEED, log_every=0,
                                            device=cuda)
        torch.cuda.empty_cache()
    ranks = tp_ep_ranks(TP_EP_TRAIN)
    counts_b = only(ops)
    runs = {}
    for arch, layers in TP_EP_TRAIN:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        want = {k: TP_EP_STEPS * n for k, n in train_launches(ops, cfg).items()}
        plain = np.array(plain_runs[arch]["losses"])
        for r, res in enumerate(ranks):
            got = res[arch]
            assert got["launches"] == want, (arch, r, got["launches"], want)
            counts_b = {k: counts_b[k] + n for k, n in got["launches"].items()}
            assert got["losses"] == ranks[0][arch]["losses"], (arch, "the ranks disagree")
        losses = np.array(ranks[0][arch]["losses"])
        assert losses.shape == (TP_EP_STEPS,) and np.isfinite(losses).all(), (arch, losses)
        diff = float(np.abs(losses - plain).max())
        assert diff <= TP_EP_LOSS_ATOL, (arch, losses.tolist(), plain.tolist())
        if "moe" in cfg.block_pattern:
            assert (np.array(ranks[0][arch]["aux"]) > 0).all(), arch
        steady = float(np.median(ranks[0][arch]["step_seconds"][1:]))
        runs[arch] = {"layers": layers, "losses": losses.tolist(), "plain_losses": plain.tolist(),
                      "max_loss_diff": diff, "step_seconds": ranks[0][arch]["step_seconds"],
                      "plain_step_seconds": plain_runs[arch]["step_seconds"],
                      "steady_step_s": steady,
                      "plain_steady_step_s": float(np.median(
                          plain_runs[arch]["step_seconds"][1:])),
                      "peak_gb_per_rank": [res[arch]["peak_gb"] for res in ranks],
                      "launches_per_rank": ranks[0][arch]["launches"]}
    ph.info.update(train=runs, launches_b=counts_b)
    emit({"tp_ep_train": runs, "nvidia_smi": nvidia_smi()})
    return {k: counts_a[k] + counts_b[k] for k in counts_a}


# phases simulate, process and dashboard
SIM_WIDTHS = (1, 2, 4, 8, 16, 32, 64, 128)
PROJECTION_FACTOR = 2.0    # the 1-worker projection against the measured 1-worker wall
PROCESS_WORKERS = 4
# calibration units (phase simulate): each reaches the pipeline's own task
# size, where the card's tasks are not launch-bound.  KNN's units are rows:
# a test block's 12,500 for KNN_frag, a training fragment's 125,000 for
# the fill (fitted up to 12,500 rows only, it projected 0.61 of the
# measured 1-worker wall: the fill is superlinear past the caches)
CALIBRATE = {"knn": dict(d=50, k=5, n_classes=4, units=(3125, 6250, 12_500, 125_000),
                         n_train_frag=125_000),
             "kmeans": dict(d=50, k=16, units=(125_000, 250_000, 500_000)),
             "linreg": dict(p=100, units=(31_250, 62_500, 125_000))}


def zero_machine(sim, workers: int):
    """One node of ``workers`` workers with zero transport and dispatch:
    the machine on which Graham's bounds hold."""
    return sim.MachineModel(n_nodes=1, workers_per_node=workers, ser_Bps=None,
                            dispatch_overhead_s=0.0)


def cost_rows(costs) -> list:
    """Each cost model's a, b, its samples and the fit's largest relative
    residual."""
    return [{"task": m.name, "a": m.a, "b": m.b, "samples": m.samples,
             "max_rel_residual": max(abs(m(u) - t) / t for u, t in m.samples)}
            for m in vars(costs).values()]


def project(sim, tasks) -> dict:
    """Projected makespan and strong-scaling efficiency T1 / (P * T_P) at
    each width of ``SIM_WIDTHS``; raises where Graham's bounds
    ``max(T1/P, Tinf) <= T_P <= T1/P + Tinf`` fail."""
    out, t1 = {}, None
    for w in SIM_WIDTHS:
        r = sim.simulate(tasks, zero_machine(sim, w))
        lo = max(r.total_work / w, r.critical_path)
        hi = r.total_work / w + r.critical_path
        assert lo * (1 - 1e-12) <= r.makespan <= hi * (1 + 1e-12), \
            f"Graham's bounds fail at {w} workers: {lo} <= {r.makespan} <= {hi}"
        t1 = r.makespan if t1 is None else t1
        out[w] = {"makespan_s": r.makespan, "efficiency": t1 / (w * r.makespan)}
    return out


def plane_names(ex) -> set:
    """The names of the segments the executor's plane holds now: inputs
    and adopted results alike (``/dev/shm`` is shared with every other
    process on the machine, so only these are checked)."""
    return set(ex.plane._by_name)


def compute_app_pids() -> dict:
    """pid -> used memory, from nvidia-smi's list of compute processes
    (recorded; on the card's machine it lists one app, pid 1)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, mem = (f.strip() for f in line.split(",", 1))
        apps[int(pid)] = mem
    return apps


def check_dashboard(rt) -> dict:
    """Fetch every endpoint of the runtime's dashboard (ephemeral port) and
    hold what it serves against the runtime; a failed fetch raises."""
    import urllib.request
    url = rt.dashboard.url

    def get(path: str) -> bytes:
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            assert resp.status == 200, f"{path}: HTTP {resp.status}"
            return resp.read()

    status = json.loads(get("api/status"))
    stats = rt.stats()
    for key, stat in (("submitted", "tasks_submitted"), ("done", "tasks_done"),
                      ("failed", "tasks_failed"), ("retries", "retries")):
        assert status["tasks"][key] == stats[stat], (key, status["tasks"], stat, stats[stat])
    tasks = json.loads(get("api/tasks?since=0"))
    done = sum(e["kind"] == "done" for e in tasks["events"])
    assert tasks["dropped"] == 0 and done == stats["tasks_done"], (done, stats["tasks_done"])
    transfers = json.loads(get("api/transfers"))
    assert transfers["transfers"] == rt.store.transfer_detail()["transfers"]
    trace = json.loads(get("api/trace"))
    spans = sum(ev.get("ph") == "X" for ev in trace["traceEvents"])
    assert spans >= stats["tasks_done"], (spans, stats["tasks_done"])
    page = get("")
    assert b"Task stream" in page
    return {"url": url, "tasks_done": stats["tasks_done"], "events": len(tasks["events"]),
            "trace_spans": spans, "transfers": transfers["transfers"],
            "nodes": sorted(status["nodes"]), "page_bytes": len(page)}


def kill_during(ex, task: str, killed: list, timeout: float = 60.0) -> None:
    """SIGKILL the first worker seen running ``task`` (its head of pipe)."""
    import signal
    deadline = time.time() + timeout
    while time.time() < deadline:
        for w in range(ex.n_workers):
            if ex.running_task(w) == task:
                os.kill(ex.worker_pids[w], signal.SIGKILL)
                killed.append(w)
                return
        time.sleep(0.0005)


CLUSTER_AGENTS, CLUSTER_WORKERS = 2, 2     # phase cluster: agents x workers per agent
CLUSTER_RELAY_SHARE = 0.05                  # KNN's scheduler relay bytes / its fill bytes


def agent_processes() -> list:
    """pids of the live processes running ``repro_torch.cluster.agent``."""
    out = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read()
            with open(f"/proc/{pid}/stat") as fh:
                state = fh.read().rsplit(")", 1)[1].split()[0]
        except OSError:
            continue
        if b"repro_torch.cluster.agent" in cmd and state != "Z":
            out.append(int(pid))
    return out


def pid_alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def cluster_counters(rt) -> dict:
    """The data-plane counters a pipeline moves, read now."""
    ex = rt.executor
    return {"relay_bytes": ex.stats()["relay_bytes"], "fetch_bytes": ex.fetch_bytes,
            "remote_results": ex.remote_results, "p2p_bytes": rt.stats()["p2p_bytes"],
            "gather_bytes": rt.store.transfer_detail()["gather_bytes"]}


def kill_agent_during(rt, task: str, killed: list, timeout: float = 60.0) -> None:
    """SIGKILL the first node agent seen with ``task`` in flight."""
    import signal
    ex = rt.executor
    deadline = time.time() + timeout
    while time.time() < deadline:
        for a in range(ex.n_agents):
            if any(req[1].t.name == task for req in list(ex._inflight_reqs[a].values())):
                os.kill(rt.cluster._procs[a].pid, signal.SIGKILL)
                killed.append(a)
                return
        time.sleep(0.0005)


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout whose knn_topk, kmeans_assign, ssd_scan and rmsnorm "
                         "kernels are "
                         "timed beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; one CUDA card is needed",
              file=sys.stderr)
        return 2
    # a fixed cuBLAS workspace: the process phase runs linreg's float64
    # GEMMs under torch.use_deterministic_algorithms, which needs it; set
    # before the first cuBLAS call, and inherited by spawned workers
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.algorithms import kmeans, knn, linreg
    from repro_torch.algorithms.common import make_blobs
    from repro_torch.core import api, serialization
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
        smi = nvidia_smi()
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
    thread_wall = {}       # pipeline -> its wall under the thread backend
    knn_cfg = dict(n_train=2_000_000, n_test=50_000, d=50, k=5, n_classes=4,
                   train_fragments=16, test_blocks=4)
    with Phase("knn") as ph:
        ops.reset_launch_counts()
        with api.runtime_start(n_workers=4, backend="thread") as rt:
            res = knn.run_knn(**knn_cfg, seed=SEED, device=cuda)
        ph.info["pipeline_seconds"] = thread_wall["knn"] = rt.tracer.wallclock()
        ph.info["task_seconds"] = task_seconds(rt)
        counts = ops.launch_counts()
        launches["knn_topk"] = counts["knn_topk"]
        assert counts == only(ops, knn_topk=64), counts
        preds = res.predictions
        assert preds.shape == (50_000,) and preds.min() >= 0 and preds.max() < 4
        agree = knn_oracle_agreement(knn, knn_k, make_blobs, preds, cuda, **knn_cfg)
        assert agree >= 999, f"only {agree}/1000 predictions agree with the fp64 oracle"
        ph.info.update(tasks=res.n_tasks, launches=counts, oracle_agree=agree)

    km_cfg = dict(n_points=8_000_000, d=50, k=16, fragments=16, max_iters=10, tol=0.0,
                  seed=SEED, device=cuda)
    lr_cfg = dict(n_rows=2_000_000, p=100, n_pred=100_000, fragments=16, pred_blocks=4,
                  seed=SEED, device=cuda)
    with Phase("kmeans") as ph:
        cfg = km_cfg
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
        thread_wall["kmeans"] = t_first
        ph.info.update(first_run_seconds=t_first, sse_history=hist, shifts=r1.shifts)

    with Phase("linreg") as ph:
        n_rows, p, fragments = lr_cfg["n_rows"], lr_cfg["p"], lr_cfg["fragments"]
        ops.reset_launch_counts()
        with api.runtime_start(n_workers=4, backend="thread") as rt:
            r = linreg.run_linreg(**lr_cfg)
        assert ops.launch_counts() == only(ops)
        ph.info["pipeline_seconds"] = thread_wall["linreg"] = rt.tracer.wallclock()
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

    with Phase("simulate") as ph:
        # card-calibrated cost models, the pipelines' DAGs at this script's
        # sizes, and their projections: projections, not measurements of a
        # many-core node
        from repro_torch.algorithms import common
        from repro_torch.core import simulator as sim
        ops.reset_launch_counts()
        costs = {"knn": knn.calibrate(**CALIBRATE["knn"], device=cuda),
                 "kmeans": kmeans.calibrate(**CALIBRATE["kmeans"], device=cuda),
                 "linreg": linreg.calibrate(**CALIBRATE["linreg"], device=cuda)}
        ph.info["cost_models"] = {name: cost_rows(c) for name, c in costs.items()}
        # a synchronised timer reads the task's device work: the calibrated
        # hot tasks at the pipelines' task sizes cost at least half their
        # kernel's device time (a timer reading launches reads ~10 us of
        # KNN_frag's 4.2 ms; synchronised it read 0.98x the profiler's)
        frag_s = costs["knn"].frag(12_500)
        psum_s = costs["kmeans"].psum(km_cfg["n_points"] // km_cfg["fragments"])
        assert frag_s >= 0.5e-3 * rows[0]["ms"], (frag_s, rows[0]["ms"])
        assert psum_s >= 0.5e-3 * rows[1]["ms"], (psum_s, rows[1]["ms"])
        ph.info["hot_task_s"] = {"KNN_frag": frag_s, "KNN_frag_kernel": 1e-3 * rows[0]["ms"],
                                 "partial_sum": psum_s,
                                 "partial_sum_kernel": 1e-3 * rows[1]["ms"]}
        dags = {"knn": knn.dag_spec(costs["knn"], n_train=knn_cfg["n_train"],
                                    n_test=knn_cfg["n_test"], d=knn_cfg["d"], k=knn_cfg["k"],
                                    train_fragments=knn_cfg["train_fragments"],
                                    test_blocks=knn_cfg["test_blocks"],
                                    calib_frag_rows=CALIBRATE["knn"]["n_train_frag"]),
                "kmeans": kmeans.dag_spec(costs["kmeans"], km_cfg["n_points"], km_cfg["d"],
                                          km_cfg["k"], km_cfg["fragments"],
                                          km_cfg["max_iters"]),
                "linreg": linreg.dag_spec(costs["linreg"], lr_cfg["n_rows"], lr_cfg["p"],
                                          lr_cfg["n_pred"], lr_cfg["fragments"],
                                          lr_cfg["pred_blocks"])}
        projected = {name: project(sim, tasks) for name, tasks in dags.items()}
        runs = {"knn": lambda: knn.run_knn(**knn_cfg, seed=SEED, device=cuda),
                "kmeans": lambda: kmeans.run_kmeans(**km_cfg),
                "linreg": lambda: linreg.run_linreg(**lr_cfg)}
        one_worker = {}
        for name, run in runs.items():
            with api.runtime_start(n_workers=1, backend="thread") as rt:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                replay = sim.replay_graph(rt.graph)
            proj = projected[name][1]["makespan_s"]
            one_worker[name] = {
                "measured_wall_s": wall, "projected_s": proj, "ratio": proj / wall,
                "tasks": len(dags[name]), "replayed_tasks": len(replay),
                "replay_1_worker_s": sim.simulate(replay, zero_machine(sim, 1)).makespan}
            assert len(replay) == len(dags[name]), (name, len(replay), len(dags[name]))
            assert 1 / PROJECTION_FACTOR <= proj / wall <= PROJECTION_FACTOR, \
                f"{name}: 1-worker projection {proj} s against a measured {wall} s"
        # calibrate_cost times each unit `repeats` times; KNN_merge and
        # KNN_classify (merge and update_centroids) build their input with
        # one launch per unit; then one run of each pipeline
        repeats = inspect.signature(common.calibrate_cost).parameters["repeats"].default
        calib = {name: len(CALIBRATE[name]["units"]) * (repeats + 2)
                 for name in ("knn", "kmeans")}
        counts = ops.launch_counts()
        assert counts == only(ops, knn_topk=calib["knn"] + 64,
                              kmeans_assign=calib["kmeans"] + 160), (calib, counts)
        launches_sim = counts
        ph.info.update(projected=projected, one_worker=one_worker, launches=counts)

    with Phase("process") as ph:
        # the three pipelines in PROCESS_WORKERS spawned worker processes,
        # each its own CUDA context; float64 GEMMs under deterministic
        # algorithms (the workers take the setting at spawn)
        ops.reset_launch_counts()
        torch.use_deterministic_algorithms(True)
        # what the parent's allocator holds from the earlier phases, so the
        # growth below is this phase's own
        torch.cuda.empty_cache()
        reserved_before = torch.cuda.memory_reserved()
        try:
            t0 = time.perf_counter()
            rt = api.runtime_start(n_workers=PROCESS_WORKERS, backend="process",
                                   dashboard_port=0, max_retries=1)
            pool_start = time.perf_counter() - t0   # every worker up, its CUDA context made
            ex = rt.executor
            planed = set()    # every segment name this runtime's plane held
            try:
                walls = {}
                for name, run in runs.items():
                    t0 = time.perf_counter()
                    out = run()
                    torch.cuda.synchronize()
                    walls[name] = time.perf_counter() - t0
                    planed |= plane_names(ex)
                    if name == "knn":
                        assert out.predictions.tobytes() == preds.tobytes(), \
                            "KNN predictions differ between the process and thread backends"
                    elif name == "kmeans":
                        assert out.centroids.tobytes() == r1.centroids.tobytes(), \
                            "K-means centroids differ between the process and thread backends"
                        assert out.sse_history == r1.sse_history, (out.sse_history, r1.sse_history)
                    else:
                        assert out.beta.tobytes() == r.beta.tobytes(), \
                            "linreg beta differs between the process and thread backends"
                        assert out.predictions.tobytes() == r.predictions.tobytes()
                st = rt.stats()["executor"]
                gathered = {k: st["kernel_launches"].get(k, 0) for k in ops.KERNELS}
                assert gathered == only(ops, knn_topk=64, kmeans_assign=160), gathered
                assert ops.launch_counts() == only(ops), "the parent launched a kernel"
                # every worker holds card memory: each reports what its
                # allocator reserves, and the card's used memory covers
                # the parent's and the workers' together.  (nvidia-smi on
                # the card's machine lists one compute app, pid 1, with
                # every process's memory summed: it cannot name a pid.)
                pids = ex.worker_pids
                by_pid = st["card_bytes_by_pid"]
                assert all(by_pid.get(pid, 0) > 0 for pid in pids), (pids, by_pid)
                free, total = torch.cuda.mem_get_info()
                workers_bytes = sum(by_pid[pid] for pid in pids)
                assert total - free >= torch.cuda.memory_reserved() + workers_bytes, \
                    (total - free, torch.cuda.memory_reserved(), workers_bytes)
                apps = compute_app_pids()
                ph.info.update(
                    pool_start_s=pool_start, wall_s=walls, thread_wall_s=thread_wall,
                    start_method=st["start_method"],
                    pipeline_depth=st["pipeline_depth"], bytes_planed=st["bytes_planed"],
                    device_uploads=st["device_uploads"],
                    device_upload_bytes=st["device_upload_bytes"],
                    device_uploads_saved=st["device_uploads_saved"],
                    worker_cache_hits=st["worker_cache_hits"], launches=gathered,
                    worker_card_bytes={str(pid): by_pid[pid] for pid in pids},
                    card_used_bytes=total - free,
                    parent_reserved_bytes=torch.cuda.memory_reserved(),
                    parent_reserved_before_bytes=reserved_before,
                    parent_allocated_bytes=torch.cuda.memory_allocated(),
                    nvidia_smi_compute_apps=apps)

                with Phase("dashboard") as dph:
                    dph.info.update(check_dashboard(rt))

                # one SIGKILL of a worker while it runs KNN_frag
                restarts = ex.worker_restarts
                killed = []
                killer = threading.Thread(target=kill_during, args=(ex, "KNN_frag", killed))
                killer.start()
                t0 = time.perf_counter()
                again = runs["knn"]()
                kill_run = time.perf_counter() - t0
                killer.join()
                assert killed, "no worker was seen running KNN_frag"
                assert again.predictions.tobytes() == preds.tobytes(), \
                    "the predictions changed after a worker was killed"
                assert ex.worker_restarts == restarts + 1, (restarts, ex.worker_restarts)
                st = rt.stats()
                ph.info.update(killed_worker=killed[0], worker_restarts=ex.worker_restarts,
                               retries=st["retries"], kill_run_s=kill_run)
                launches_proc = {k: st["executor"]["kernel_launches"].get(k, 0)
                                 for k in ops.KERNELS}
                # a killed task's launches die with its worker: only
                # replied tasks are counted, so the retried run adds 64
                assert launches_proc == only(ops, knn_topk=128, kmeans_assign=160), \
                    launches_proc
                ph.info["launches_with_the_kill_run"] = launches_proc
            finally:
                planed |= plane_names(ex)
                api.runtime_stop()
        finally:
            torch.use_deterministic_algorithms(False)
        assert planed, "the plane held no segment"
        left = sorted(n for n in planed if os.path.exists(os.path.join("/dev/shm", n)))
        assert not left, f"segments left in /dev/shm: {left}"
        ph.info["segments_checked"] = len(planed)
    with Phase("cluster") as ph:
        # the three pipelines on CLUSTER_AGENTS node agents over TCP, each
        # with CLUSTER_WORKERS spawned workers (each its own CUDA context;
        # the agents hold host bytes only); float64 GEMMs under
        # deterministic algorithms, which the agents pass to their workers
        ops.reset_launch_counts()
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            rt = api.runtime_start(backend="cluster", n_agents=CLUSTER_AGENTS,
                                   workers_per_node=CLUSTER_WORKERS, max_retries=1)
            cluster_start = time.perf_counter() - t0   # every agent's pool up
            ex = rt.executor
            segments, worker_pids = set(), set()

            def agents_report():
                stats = ex.agent_stats()
                assert all(s is not None for s in stats), "an agent did not answer"
                for s in stats:
                    segments.update(s["segment_names"])
                    worker_pids.update(s["worker_pids"])
                return stats

            try:
                walls, moved = {}, {}
                for name, run in runs.items():
                    before = cluster_counters(rt)
                    t0 = time.perf_counter()
                    out = run()
                    torch.cuda.synchronize()
                    walls[name] = time.perf_counter() - t0
                    after = cluster_counters(rt)
                    moved[name] = {k: after[k] - before[k] for k in after}
                    if name == "knn":
                        assert out.predictions.tobytes() == preds.tobytes(), \
                            "KNN predictions differ between the cluster and thread backends"
                    elif name == "kmeans":
                        assert out.centroids.tobytes() == r1.centroids.tobytes(), \
                            "K-means centroids differ between the cluster and thread backends"
                        assert out.sse_history == r1.sse_history, (out.sse_history, r1.sse_history)
                    else:
                        assert out.beta.tobytes() == r.beta.tobytes(), \
                            "linreg beta differs between the cluster and thread backends"
                        assert out.predictions.tobytes() == r.predictions.tobytes()
                st = ex.stats()
                gathered = {k: st["kernel_launches"].get(k, 0) for k in ops.KERNELS}
                assert gathered == only(ops, knn_topk=64, kmeans_assign=160), gathered
                assert ops.launch_counts() == only(ops), "the scheduler launched a kernel"
                agents = agents_report()
                assert not any(s["cuda_initialized"] for s in agents), \
                    "a node agent initialised CUDA"
                pool_pids = [pid for s in agents for pid in s["worker_pids"]]
                by_pid = st["card_bytes_by_pid"]
                assert len(pool_pids) == CLUSTER_AGENTS * CLUSTER_WORKERS
                assert all(by_pid.get(pid, 0) > 0 for pid in pool_pids), (pool_pids, by_pid)
                fill_bytes = knn_cfg["n_train"] * (knn_cfg["d"] * 4 + 4)   # fp32 rows, int32 labels
                relay_share = moved["knn"]["relay_bytes"] / fill_bytes
                assert relay_share < CLUSTER_RELAY_SHARE, (moved["knn"], fill_bytes)
                ph.info.update(
                    cluster_start_s=cluster_start, wall_s=walls, thread_wall_s=thread_wall,
                    moved=moved, knn_fill_bytes=fill_bytes, knn_relay_share=relay_share,
                    launches=gathered, agent_pids=[p.pid for p in rt.cluster._procs],
                    worker_card_bytes={str(pid): by_pid[pid] for pid in pool_pids},
                    agents_cuda_initialized=[s["cuda_initialized"] for s in agents],
                    device_uploads=st["device_uploads"],
                    device_upload_bytes=st["device_upload_bytes"],
                    device_uploads_saved=st["device_uploads_saved"],
                    puts=st["puts"], refs=st["refs"], fetches=st["fetches"],
                    bytes_shipped=st["bytes_shipped"],
                    relay_result_bytes=st["relay_result_bytes"],
                    deferred_result_bytes=st["deferred_result_bytes"])

                # one SIGKILL of an agent while it has KNN_frag in flight
                restarts = ex.agent_restarts
                killed = []
                killer = threading.Thread(target=kill_agent_during,
                                          args=(rt, "KNN_frag", killed))
                t_kill = time.perf_counter()
                killer.start()
                again = runs["knn"]()
                kill_run = time.perf_counter() - t_kill
                killer.join()
                assert killed, "no agent was seen running KNN_frag"
                assert again.predictions.tobytes() == preds.tobytes(), \
                    "the predictions changed after an agent was killed"
                deadline = time.monotonic() + 120
                while ex.agent_restarts == restarts and time.monotonic() < deadline:
                    time.sleep(0.05)
                assert ex.agent_restarts == restarts + 1, (restarts, ex.agent_restarts)
                # only replied tasks are counted: a task whose agent died
                # with it in flight launches again, once, in its retry,
                # and a lost result's producer once more per re-execution
                frag_done = sum(1 for e in rt.tracer.events("task")
                                if e.name == "KNN_frag" and e.t0 >= t_kill and e.meta["ok"])
                st = ex.stats()
                launches_cluster = {k: st["kernel_launches"].get(k, 0) for k in ops.KERNELS}
                assert launches_cluster == only(ops, knn_topk=64 + frag_done,
                                                kmeans_assign=160), (frag_done, launches_cluster)
                assert ops.launch_counts() == only(ops), "the scheduler launched a kernel"
                agents = agents_report()
                assert not any(s["cuda_initialized"] for s in agents)
                stats = rt.stats()
                ph.info.update(killed_agent=killed[0], agent_restarts=ex.agent_restarts,
                               retries=stats["retries"], kill_run_s=kill_run,
                               knn_frag_completions=frag_done,
                               knn_frag_reexecutions=frag_done - 64,
                               launches_with_the_kill_run=launches_cluster)
            finally:
                pids = set(p.pid for p in rt.cluster._procs if p is not None)
                api.runtime_stop()
        finally:
            torch.use_deterministic_algorithms(False)
        left = agent_processes()
        assert not left, f"node agents left running: {left}"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            stray = sorted(p for p in worker_pids | pids if pid_alive(p))
            stale = sorted(n for n in segments if os.path.exists(os.path.join("/dev/shm", n)))
            if not stray and not stale:
                break
            time.sleep(0.1)
        assert not stray, f"agents or pool workers left running: {stray}"
        assert segments, "the agents' planes held no segment"
        assert not stale, f"segments left in /dev/shm: {stale}"
        ph.info.update(segments_checked=len(segments), workers_checked=len(worker_pids))

    with Phase("wide") as ph:
        launches_wide = wide_phase(ph, ops, knn, kmeans, api, knn_k, km_k, make_blobs, cuda)

    for name in ("knn_topk", "kmeans_assign"):
        pipeline_by_phase = {"knn" if name == "knn_topk" else "kmeans": launches[name],
                             "simulate": launches_sim[name], "process": launches_proc[name],
                             "cluster": launches_cluster[name], "wide": launches_wide[name]}
        launches[name] = sum(pipeline_by_phase.values())
        for row in rows:
            if row["name"] == name:
                row["launches_by_phase"] = pipeline_by_phase

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
        served_tokens = toks                 # phase mesh serves them again
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

    with Phase("mesh") as ph:
        by_phase["mesh"] = mesh_phase(ph, ops, lm, train, serve, get_config("qwen3-0.6b"), cuda,
                                      served_tokens)

    with Phase("tp_ep") as ph:
        by_phase["tp_ep"] = tp_ep_phase(ph, ops, lm, train, get_config, cuda)

    with Phase("codecs") as ph:
        codecs_phase(ph, serialization, cuda, smi)

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
