"""NumPy's standard-normal stream drawn on the card, bit for bit: the
fills' data (``KNN_fill_fragment``, ``KNN_gen_test``, ``fill_fragment``,
``LR_fill_fragment``, ``LR_genpred``).

``Generator.standard_normal`` is PCG64 (XSL-RR 128/64) feeding the
256-strip ziggurat of NumPy's ``random_standard_normal``: each attempt
reads one raw 64-bit draw; 99% of them return at once, a wedge test reads
one more draw (and may reject, returning nothing), the tail reads pairs
until one is accepted.  A normal therefore costs 1, 2, or 1 + 2m draws,
and where the n-th normal comes from depends on every draw before it.
:func:`normal_fill_cuda` (``csrc/normal_fill.cu``) splits the raw stream
over the card's threads anyway, and exactly:

1. *Summaries.*  The raw stream is cut into chunks of ``CHUNK`` draws; a
   thread per chunk jumps its PCG64 state there (O(log) 128-bit products,
   from a table of jumps by ``CHUNK`` x 2^j) and parses the chunk's
   tokens (attempts) from each of ``ENTRIES`` entry offsets, the first
   token of the chunk starting that many draws in (a token of the chunk
   before may reach over its end).  For each it keeps the normals made
   and the exit offset into the next chunk.  Parses from different
   offsets meet at a common token start after a token or two, so only
   the parse from offset 0 reads the whole chunk.
2. *Resolve.*  One block composes these maps: each thread over a segment
   of chunks, then a scan over the segments, then each segment's walk
   gives every chunk its true entry offset and the index of its first
   normal.  An entry offset beyond the summaries' (a tail token ending
   deep in the next chunk) re-parses that chunk serially (and where that
   happens at a segment boundary, the segment walks from it and stands in
   for it in another scan): a correctness path, counted on the card
   (:func:`reparses`).  Rounds that ended with an entry still unknown
   would be flagged there too, and :func:`reparses` raises.
3. *Write.*  A thread per chunk draws its tokens again in registers and
   writes each normal through the fill's epilogue: float64 as drawn
   (linear regression: the normals past ``out`` go to ``noise``), or the
   blobs' ``float32(centres[label[row], col] + z)``, the add in float64
   then rounded, as the host's ``.astype(np.float32)``.  The last chunk
   goes on past its end should the chunks provisioned (``MARGIN`` x n
   draws and ``SLACK``) hold fewer than n normals.

The arithmetic is NumPy's, operation for operation, with no fused
multiply-adds; the wedge's ``exp`` and the tail's ``log1p`` are CUDA's,
so a tail normal (about 1 in 3,700) may differ from the host's by an
ulp or two, and an accept decision could only flip where a value lies
within an ulp of its bound.

:func:`chunked_standard_normal` is the same scheme in NumPy over
``bit_generator.random_raw``, phase for phase; the CPU tests hold it
against ``Generator.standard_normal``.  :func:`normal_fill_plain` is the
op's plain version (NumPy's own generator and the epilogue);
:func:`repro_torch.kernels.ops.normal_fill` picks one by device.
"""
from __future__ import annotations

import functools
import math
import pathlib
import re
import threading
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from . import _build

CHUNK = 512             # raw draws a chunk (kChunk in csrc/normal_fill.cu)
ENTRIES = 4             # entry offsets a chunk's summary covers (kEntries)
WINDOW = 32             # token starts of the parse from offset 0 kept for merging (kWindow)
RESOLVE_THREADS = 512   # segments of the resolve block (kResolveThreads)
SATURATED = 0xFFFF      # an exit offset too large for a summary's 16 bits
MARGIN = 1.03           # raw draws provisioned a normal (NumPy spends ~1.022)
SLACK = 64              # and these more, for short fills

MULT = 0x2360ED051FC65DA44385DF649FCCF645   # PCG64's 128-bit multiplier
MASK128 = (1 << 128) - 1
MASK64 = (1 << 64) - 1
ZIG_R = 3.6541528853610087963519472518       # ziggurat_nor_r
ZIG_INV_R = 0.27366123732975827203338247596  # ziggurat_nor_inv_r

_reparse_lock = threading.Lock()
_reparse: Dict[int, torch.Tensor] = {}   # device index -> its counters on that card


# ------------------------------------------------------------------ PCG64
def pcg64_words(state: dict) -> Tuple[int, int]:
    """(state, increment) of a ``bit_generator.state`` dict of PCG64."""
    if state.get("bit_generator") != "PCG64":
        raise ValueError(f"normal_fill draws NumPy's PCG64 stream, got a "
                         f"{state.get('bit_generator')!r} state")
    return int(state["state"]["state"]), int(state["state"]["inc"])


def jump(delta: int) -> Tuple[int, int]:
    """(A, C) with PCG64's state after ``delta`` steps = A·s + C·inc (mod
    2^128): A = MULT^delta, C = Σ_{j<delta} MULT^j, by doubling."""
    a, c = 1, 0                 # the jump so far
    step_a, step_c = MULT, 1    # a jump of 2^bit steps
    while delta:
        if delta & 1:
            a, c = (step_a * a) & MASK128, (step_a * c + step_c) & MASK128
        step_a, step_c = (step_a * step_a) & MASK128, (step_c * (step_a + 1)) & MASK128
        delta >>= 1
    return a, c


@functools.lru_cache(maxsize=None)
def chunk_jumps(chunk: int = CHUNK, count: int = 32) -> Tuple[Tuple[int, int], ...]:
    """The kernel's jump table: (A, C) of ``chunk`` x 2^j steps, j < count."""
    return tuple(jump(chunk << j) for j in range(count))


def chunk_state(state: int, inc: int, c: int, chunk: int = CHUNK) -> int:
    """PCG64's state ``c`` chunks of ``chunk`` draws on, as each thread of
    the kernel finds it: one table jump a set bit of ``c``."""
    for j, (a, cc) in enumerate(chunk_jumps(chunk)):
        if c >> j & 1:
            state = (a * state + cc * inc) & MASK128
    return state


def advance(state: int, inc: int, delta: int) -> int:
    """PCG64's state ``delta`` draws on (``bit_generator.advance``)."""
    a, c = jump(delta)
    return (a * state + c * inc) & MASK128


# ------------------------------------------------------- ziggurat tables
@functools.lru_cache(maxsize=None)
def tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ki uint64, wi float64, fi float64): NumPy's ziggurat tables as the
    kernel's source holds them (``kKi``, ``kWi``, ``kFi``: hex words, the
    doubles as their bit patterns), read from it so that the CPU tests
    hold the very tables the card uses."""
    src = (pathlib.Path(__file__).resolve().parent.parent / "csrc" / "normal_fill.cu").read_text()
    out = []
    for name in ("kKi", "kWi", "kFi"):
        body = re.search(name + r"\[256\]\s*=\s*\{(.*?)\};", src, re.S).group(1)
        words = np.array([int(w, 16) for w in re.findall(r"0x([0-9a-fA-F]+)ULL", body)],
                         dtype=np.uint64)
        if words.size != 256:
            raise ValueError(f"csrc/normal_fill.cu: {name} holds {words.size} words, not 256")
        out.append(words)
    ki, wi, fi = out
    return ki, wi.view(np.float64), fi.view(np.float64)


# ------------------------------------------ the chunked scheme, in NumPy
class _Draws:
    """The raw stream from a PCG64 state, drawn with ``random_raw`` as far
    as it is read, with each draw's fast-path test and value precomputed
    (the ziggurat's first step, vectorised)."""

    def __init__(self, state: int, inc: int):
        self.state, self.inc = state, inc
        self.raw: List[int] = []
        self.fast: List[bool] = []
        self.x: List[float] = []
        self.ki, self.wi, self.fi = tables()

    def _extend(self, upto: int) -> None:
        count = max(upto + 1 - len(self.raw), len(self.raw), 4096)
        bg = np.random.PCG64()
        bg.state = {"bit_generator": "PCG64",
                    "state": {"state": advance(self.state, self.inc, len(self.raw)),
                              "inc": self.inc},
                    "has_uint32": 0, "uinteger": 0}
        r = bg.random_raw(count)
        idx = (r & np.uint64(0xFF)).astype(np.intp)
        rabs = (r >> np.uint64(9)) & np.uint64(0xFFFFFFFFFFFFF)
        x = rabs.astype(np.float64) * self.wi[idx]
        x = np.where((r >> np.uint64(8)) & np.uint64(1), -x, x)
        self.raw += r.tolist()
        self.fast += (rabs < self.ki[idx]).tolist()
        self.x += x.tolist()

    def double(self, q: int) -> float:
        if q >= len(self.raw):
            self._extend(q)
        return (self.raw[q] >> 11) * (1.0 / 9007199254740992.0)

    def token(self, q: int) -> Tuple[bool, float, int]:
        """(whether it makes a normal, the normal, draws read) of the
        attempt starting at draw ``q``: ``random_standard_normal``'s loop
        body, operation for operation."""
        if q >= len(self.raw):
            self._extend(q)
        x = self.x[q]
        if self.fast[q]:
            return True, x, 1
        r = self.raw[q]
        idx = r & 0xFF
        if idx == 0:
            rabs = (r >> 9) & 0xFFFFFFFFFFFFF
            k = 1
            while True:
                xx = -ZIG_INV_R * math.log1p(-self.double(q + k))
                yy = -math.log1p(-self.double(q + k + 1))
                k += 2
                if yy + yy > xx * xx:
                    v = xx + ZIG_R
                    return True, (-v if rabs >> 8 & 1 else v), k
        fi = self.fi
        lhs = (float(fi[idx - 1]) - float(fi[idx])) * self.double(q + 1) + float(fi[idx])
        return lhs < math.exp(-0.5 * x * x), x, 2


def _parse(draws: _Draws, c: int, entry: int, chunk: int) -> Tuple[int, int]:
    """(normals, exit offset) of chunk ``c`` parsed from ``entry``."""
    base, q, k = c * chunk, entry, 0
    while q < chunk:
        made, _, n = draws.token(base + q)
        k += made
        q += n
    return k, q - chunk


def _summaries(draws: _Draws, chunks: int, chunk: int, entries: int) -> List[List[tuple]]:
    """Phase 1: per chunk, (normals, exit offset) from each entry offset;
    the parses from offsets past 0 stop where they meet a token start of
    the parse from 0.  Exits past 16 bits saturate."""
    rows = []
    for c in range(chunks):
        base = c * chunk
        starts = outs = 0
        q = made0 = 0
        while q < chunk:
            made, _, n = draws.token(base + q)
            if q < WINDOW:
                starts |= 1 << q
                outs |= int(made) << q
            made0 += made
            q += n
        exit0 = q - chunk
        row = [(made0, exit0)]
        for e in range(1, entries):
            q, k = e, 0
            while True:
                if q >= chunk:
                    row.append((k, q - chunk))
                    break
                if q < WINDOW and starts >> q & 1:
                    row.append((k + made0 - bin(outs & ((1 << q) - 1)).count("1"), exit0))
                    break
                made, _, n = draws.token(base + q)
                k += made
                q += n
        rows.append([(k, min(x, SATURATED)) for k, x in row])
    return rows


UNKNOWN = -1            # an entry offset the scan cannot know (kUnknown)


def _compose(f, g, entries: int):
    """The map of ``f``'s segments, then ``g``'s: (exit offsets, normals,
    flat) by entry offset.  A flat map (a segment standing in for its one
    known entry) takes any entry; another, only those within the
    summaries'.  Past them, the exit is unknown."""
    fc, fa, flat = f
    gc, ga, gflat = g
    cur, acc = [], []
    for c, a in zip(fc, fa):
        if c == UNKNOWN or not (gflat or 0 <= c < entries):
            cur.append(UNKNOWN)
            acc.append(0)
        else:
            k = 0 if gflat else c
            cur.append(gc[k])
            acc.append(a + ga[k])
    return cur, acc, flat


def _scan_heads(maps, entries: int) -> List[Tuple[int, int]]:
    """Each segment's (first normal, entry offset): the prefix of the
    maps before it at offset 0, by the kernel's two-level scan (within
    warps of 32 by shuffles up, then over the warps' totals)."""
    ident = (list(range(entries)), [0] * entries, False)

    def warp_scan(ms):
        for off in (1, 2, 4, 8, 16):
            ms = [_compose(ms[i - off], m, entries) if i >= off else m for i, m in enumerate(ms)]
        return ms

    lanes = [warp_scan(maps[w:w + 32]) for w in range(0, len(maps), 32)]
    totals = warp_scan([ms[31] for ms in lanes] + [ident] * (32 - len(lanes)))
    heads = []
    for w, ms in enumerate(lanes):
        before_warp = totals[w - 1] if w else ident
        for i in range(32):
            cur, acc, _ = _compose(before_warp, ms[i - 1], entries) if i else before_warp
            heads.append((acc[0], cur[0]))
    return heads


def _resolve(rows, draws: _Draws, chunks: int, chunk: int, entries: int,
             threads: int) -> Tuple[List[Tuple[int, int]], int, int]:
    """Phase 2: every chunk's (index of its first normal, entry offset),
    the chunks re-parsed serially, and the segments that stood in for
    one entry."""
    reparses = 0

    def step(j, k):
        nonlocal reparses
        if 0 <= k < entries and rows[j][k][1] != SATURATED:
            return rows[j][k]
        reparses += 1
        return _parse(draws, j, k, chunk)

    per = -(-chunks // threads)
    threads = -(-threads // 32) * 32               # whole warps: the rest hold no chunks
    segments = [range(t * per, min((t + 1) * per, chunks)) for t in range(threads)]
    maps = []                      # each segment's map: entry -> (exit, normals)
    for seg in segments:
        cur, acc = list(range(entries)), [0] * entries
        for j in seg:
            for e in range(entries):
                k, x = step(j, cur[e])
                acc[e] += k
                cur[e] = x
        maps.append((cur, acc, False))
    # the scan, as the kernel's block runs it, in rounds: a segment whose
    # entry is known but past the summaries' offsets walks from it and
    # stands in for that entry alone (a flat map), until no entry of a
    # segment that holds chunks is unknown
    held = [len(seg) > 0 for seg in segments]
    fixed = [False] * threads
    stand_ins = 0
    for _ in range(threads + 1):
        heads = _scan_heads(maps, entries)
        if not any(h and e == UNKNOWN for h, (_, e) in zip(held, heads)):
            break
        for t, (seg, (_, entry)) in enumerate(zip(segments, heads)):
            if held[t] and not fixed[t] and entry >= entries:
                made = 0
                for j in seg:
                    k, entry = step(j, entry)
                    made += k
                maps[t] = ([entry] * entries, [made] * entries, True)
                fixed[t] = True
                stand_ins += 1
    else:
        raise AssertionError("the resolve rounds did not end")
    starts = [None] * chunks
    for seg, (base, entry) in zip(segments, heads):
        for j in seg:
            starts[j] = (base, entry)
            k, entry = step(j, entry)
            base += k
    return starts, reparses, stand_ins


class Chunked(NamedTuple):
    z: np.ndarray         # the normals
    spent: int            # raw draws up to the end of the last normal's token
    reparses: int         # chunks re-parsed serially
    entries: List[int]    # each chunk's entry offset
    stand_ins: int        # segments entered past the summaries' offsets


def chunked_standard_normal(state: int, inc: int, n: int, *, chunk: int = CHUNK,
                            entries: int = ENTRIES, threads: int = RESOLVE_THREADS) -> Chunked:
    """The kernel's scheme in NumPy over the PCG64 stream at (``state``,
    ``inc``): its next ``n`` normals, and what the phases found.  Equals
    ``standard_normal(n)`` and its draws bit for bit; slow (a Python loop
    a token): tests only."""
    draws = _Draws(state, inc)
    chunks = chunk_count(n, chunk)
    rows = _summaries(draws, chunks, chunk, entries)
    starts, reparses, stand_ins = _resolve(rows, draws, chunks, chunk, entries, threads)
    z = np.empty(n, dtype=np.float64)
    spent = 0
    for j, (base, q) in enumerate(starts):            # phase 3
        i = base
        while i < n and (q < chunk or j == chunks - 1):
            made, x, k = draws.token(j * chunk + q)
            q += k
            if made:
                z[i] = x
                i += 1
                if i == n:
                    spent = j * chunk + q
    return Chunked(z, spent, reparses, [q for _, q in starts], stand_ins)


def chunk_count(n: int, chunk: int = CHUNK) -> int:
    """Chunks provisioned for ``n`` normals: ``MARGIN`` x n + ``SLACK`` draws."""
    return max(1, -(-(math.ceil(n * MARGIN) + SLACK) // chunk))


# ----------------------------------------------------------- the op
def _check(out, noise, centres, labels) -> Tuple[int, int, int]:
    """(kind, normals into ``out``, normals in all) of a fill's tensors:
    kind 0 is float64 ``out`` (then ``noise``), kind 1 the float32 blobs
    ``float32(centres[labels[row], col] + z)`` of ``out`` (rows, d)."""
    dev = out.device
    tensors = [t for t in (out, noise, centres, labels) if t is not None]
    if any(t.device != dev for t in tensors):
        raise ValueError(f"normal_fill: tensors on {sorted({str(t.device) for t in tensors})}, "
                         f"expected one device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("normal_fill: every tensor must be contiguous")
    if out.dtype == torch.float64:
        if centres is not None or labels is not None:
            raise ValueError("normal_fill: centres and labels go with a float32 out")
        if noise is not None and noise.dtype != torch.float64:
            raise TypeError(f"normal_fill: noise is {noise.dtype}, expected float64")
        main = out.numel()
        return 0, main, main + (0 if noise is None else noise.numel())
    if out.dtype != torch.float32:
        raise TypeError(f"normal_fill: out is {out.dtype}, expected float64 or float32")
    if noise is not None or centres is None or labels is None:
        raise ValueError("normal_fill: a float32 out takes centres and labels, and no noise")
    if (out.dim() != 2 or centres.dim() != 2 or centres.shape[1] != out.shape[1]
            or labels.shape != (out.shape[0],)):
        raise ValueError(f"normal_fill: out {tuple(out.shape)}, centres {tuple(centres.shape)}, "
                         f"labels {tuple(labels.shape)}: expected (rows, d), (classes, d), (rows,)")
    if centres.dtype != torch.float64 or labels.dtype != torch.int32:
        raise TypeError(f"normal_fill: centres {centres.dtype}, labels {labels.dtype}: "
                        f"expected float64 and int32")
    return 1, out.numel(), out.numel()


def normal_fill_plain(state: dict, out: torch.Tensor, *, noise=None, centres=None,
                      labels=None) -> torch.Tensor:
    """Plain version: NumPy's own generator from ``state`` draws the
    normals, then the epilogue of :func:`normal_fill_cuda` in NumPy."""
    kind, main, total = _check(out, noise, centres, labels)
    rng = np.random.Generator(np.random.PCG64())
    rng.bit_generator.state = state
    z = rng.standard_normal(total)
    if kind == 0:
        out.copy_(torch.from_numpy(z[:main].reshape(out.shape)))
        if noise is not None:
            noise.copy_(torch.from_numpy(z[main:].reshape(noise.shape)))
    else:
        c, lab = centres.cpu().numpy(), labels.cpu().numpy()
        out.copy_(torch.from_numpy((c[lab] + z.reshape(out.shape)).astype(np.float32)))
    return out


def _reparse_counter(dev: torch.device) -> torch.Tensor:
    """The card's two int64 words: chunks re-parsed serially, and resolves
    whose rounds ended with a chunk's entry still unknown."""
    with _reparse_lock:
        t = _reparse.get(dev.index)
        if t is None:
            t = _reparse[dev.index] = torch.zeros(2, dtype=torch.int64, device=dev)
        return t


def reparses() -> int:
    """Chunks re-parsed serially since the last reset, over every card
    this process filled on (reading it waits for those cards' fills).
    Raises if a fill's resolve left a chunk's entry unknown: its output
    is not the stream."""
    with _reparse_lock:
        counters = [t.tolist() for t in _reparse.values()]
    if any(unresolved for _, unresolved in counters):
        raise RuntimeError("normal_fill: a resolve ended with a chunk's entry offset unknown")
    return sum(count for count, _ in counters)


def reset_reparses() -> None:
    with _reparse_lock:
        for t in _reparse.values():
            t.zero_()


def normal_fill_cuda(state: dict, out: torch.Tensor, *, noise=None, centres=None,
                     labels=None) -> torch.Tensor:
    """Fill ``out`` (and ``noise``) on its CUDA device with the stream's
    next normals through the epilogue of their kind (see :func:`_check`),
    asynchronously on the current stream.  ``state`` is the generator's
    ``bit_generator.state``; the generator is read, not advanced.
    ``labels`` must index rows of ``centres``: the card does not check."""
    kind, main, total = _check(out, noise, centres, labels)
    dev = _build.require("normal_fill_cuda", [("out", out, None)], contiguous=False)
    s, inc = pcg64_words(state)
    d = out.shape[1] if kind == 1 else 1
    if total > 2**31 - 1:
        raise ValueError(f"normal_fill_cuda: {total} normals in one fill, at most 2^31 - 1")
    if total:
        chunks = chunk_count(total)
        summary = torch.empty((chunks, ENTRIES), dtype=torch.int32, device=dev)
        counter = _reparse_counter(dev)
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _build.launch("normal_fill", "normal_fill_launch", dev,
                      s & MASK64, s >> 64, inc & MASK64, inc >> 64, total, main, kind, chunks,
                      summary.data_ptr(), counter.data_ptr(), out.data_ptr(), ptr(noise),
                      ptr(centres), ptr(labels), d)
    return out
