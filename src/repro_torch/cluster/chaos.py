"""Deterministic chaos injection for the cluster runtime (DESIGN.md §19).

``RJAX_CHAOS=<seed>:<spec>`` arms a seeded fault injector at process
start — in the scheduler *and* (because spawned agents inherit the
environment) in every node agent.  ``<spec>`` is a comma-separated list
of fault classes, each optionally carrying an argument and a firing
rate::

    RJAX_CHAOS="1234:delay=0.02@0.3,hang=5@0.1,fetch-slow=0.2"

    <fault>[=<arg>][@<rate>]      # rate defaults per fault, arg too

Fault classes and the seams they fire at:

=============  =========================================================
``delay``      sleep ``arg`` seconds before a control-plane message is
               sent/queued (``AgentChannel``/``AsyncAgentChannel`` send
               paths) — network latency.
``drop``       swallow a heartbeat push on the agent before it is sent —
               heartbeat loss.  Only at-most-once telemetry traffic is
               droppable: request/reply messages ride TCP's reliable
               stream by design, and losing one *is* the connection-death
               fault class the respawn tests already cover.
``stall``      sleep ``arg`` seconds before an agent sends a task reply —
               a node draining slowly (scheduler-side deadline food).
``freeze``     a ``DataServer`` connection accepts the fetch request and
               then never answers — the half-open peer a network
               partition leaves behind; the consumer must time out
               retryable (``PeerFetchError``), never block forever.
``hang``       wrap the task body so it sleeps ``arg`` seconds first,
               *inside the pool worker* — a wedged worker; with a
               ``deadline_s`` armed, the agent watchdog kills it.
``fetch-slow`` sleep ``arg`` seconds before a peer pull request is sent —
               a congested data plane.
``partition``  blackhole a scheduler↔agent channel for ``arg`` seconds
               without closing the socket: every send on the seam's
               endpoint stalls until the window passes (TCP keeps the
               stream intact, so nothing is *lost* — exactly what a
               transient network partition looks like).  Distinct from
               ``freeze``, which parks the DataServer.  Windows are
               per-scope: one channel partitions, the rest keep flowing.
``bitflip``    flip one bit of an out-of-band array frame before it is
               sent (``protocol.send_msg``) — wire corruption.  With
               ``RJAX_WIRE_CHECKSUM`` armed the receiver detects it and
               fails the transfer retryably; without checksums this is
               the silent corruption the knob exists to catch.
=============  =========================================================

Determinism: every (seam scope, fault) pair draws from its own
``random.Random`` stream derived from the single seed, so one seam's
firing sequence is independent of how other seams interleave — the same
seed replays the same per-seam decision sequence whenever the seam is
hit in a deterministic order.

The module-level :data:`INJECTOR` is ``None`` unless ``RJAX_CHAOS`` is
set, so every seam costs exactly one global load + ``is None`` test on
the hot path (bench-gated with the rest of dispatch overhead).
"""
from __future__ import annotations

import os
import random
import threading
import time
import zlib
from typing import Dict, Optional, Tuple

__all__ = ["ChaosInjector", "INJECTOR", "refresh", "FAULTS"]

# fault -> (default rate, default arg)
FAULTS: Dict[str, Tuple[float, float]] = {
    "delay": (0.1, 0.01),        # seconds of added send latency
    "drop": (0.25, 0.0),         # heartbeat loss probability
    "stall": (0.1, 0.05),        # seconds of added reply latency
    "freeze": (0.1, 0.0),        # half-open DataServer connection
    "hang": (0.1, 1.0),          # seconds the task body sleeps first
    "fetch-slow": (0.2, 0.05),   # seconds of added peer-pull latency
    "partition": (0.02, 2.0),    # seconds a channel is blackholed
    "bitflip": (0.05, 0.0),      # corrupt one array-frame byte pre-send
}


class ChaosSpecError(ValueError):
    """Malformed ``RJAX_CHAOS`` value."""


class ChaosInjector:
    """Seeded fault injector; one per process, armed from ``RJAX_CHAOS``.

    :meth:`roll` is the one decision point: it returns ``None`` ("don't
    inject") or the fault's argument.  Sleeping/dropping is the seam's
    job — the injector never blocks anything itself.
    """

    def __init__(self, seed: int, faults: Dict[str, Tuple[float, float]]):
        self.seed = int(seed)
        self.faults = dict(faults)
        self._lock = threading.Lock()
        self._streams: Dict[Tuple[str, str], random.Random] = {}
        # open partition windows, scope -> monotonic deadline
        self._windows: Dict[str, float] = {}

    # ------------------------------------------------------------- parsing
    @classmethod
    def parse(cls, spec: str) -> "ChaosInjector":
        """``"<seed>:<fault>[=<arg>][@<rate>],..."`` → injector."""
        seed_part, sep, fault_part = spec.partition(":")
        if not sep or not fault_part.strip():
            raise ChaosSpecError(
                f"RJAX_CHAOS={spec!r}: expected '<seed>:<fault>[=arg][@rate],...'")
        try:
            seed = int(seed_part)
        except ValueError:
            raise ChaosSpecError(
                f"RJAX_CHAOS={spec!r}: seed {seed_part!r} is not an integer")
        faults: Dict[str, Tuple[float, float]] = {}
        for clause in fault_part.split(","):
            clause = clause.strip()
            if not clause:
                continue
            name, _, rate_part = clause.partition("@")
            name, _, arg_part = name.partition("=")
            name = name.strip()
            if name not in FAULTS:
                raise ChaosSpecError(
                    f"RJAX_CHAOS={spec!r}: unknown fault {name!r} "
                    f"(known: {', '.join(sorted(FAULTS))})")
            default_rate, default_arg = FAULTS[name]
            try:
                rate = float(rate_part) if rate_part else default_rate
                arg = float(arg_part) if arg_part else default_arg
            except ValueError:
                raise ChaosSpecError(
                    f"RJAX_CHAOS={spec!r}: bad number in clause {clause!r}")
            if not 0.0 <= rate <= 1.0:
                raise ChaosSpecError(
                    f"RJAX_CHAOS={spec!r}: rate {rate} outside [0, 1]")
            faults[name] = (rate, arg)
        if not faults:
            raise ChaosSpecError(f"RJAX_CHAOS={spec!r}: no fault clauses")
        return cls(seed, faults)

    @classmethod
    def from_env(cls) -> Optional["ChaosInjector"]:
        spec = os.environ.get("RJAX_CHAOS", "").strip()
        return cls.parse(spec) if spec else None

    # ------------------------------------------------------------ decisions
    def _stream(self, fault: str, scope: str) -> random.Random:
        key = (fault, scope)
        rng = self._streams.get(key)
        if rng is None:
            # independent deterministic stream per (fault, scope): one
            # seam's draw count never perturbs another's sequence
            mix = zlib.crc32(f"{fault}|{scope}".encode())
            rng = self._streams[key] = random.Random(self.seed ^ mix)
        return rng

    def roll(self, fault: str, scope: str = "") -> Optional[float]:
        """``None`` = don't inject; else the fault's configured argument
        (seconds for the latency faults, unused for drop/freeze)."""
        ent = self.faults.get(fault)
        if ent is None:
            return None
        rate, arg = ent
        with self._lock:
            fire = self._stream(fault, scope).random() < rate
        return arg if fire else None

    def partition_window(self, scope: str = "") -> float:
        """The ``partition`` seam decision: seconds the caller must
        stall before its send may proceed (0.0 = no partition).  While
        a window is open no new rolls are drawn for the scope — one
        partition event is one decision, however many sends pile up
        behind it.  The caller does the stalling (synchronously or with
        ``asyncio.sleep`` — the async control plane's writer coroutine
        must not block its loop)."""
        if "partition" not in self.faults:
            return 0.0
        now = time.monotonic()
        with self._lock:
            deadline = self._windows.get(scope, 0.0)
            if now >= deadline:
                rate, arg = self.faults["partition"]
                if self._stream("partition", scope).random() < rate \
                        and arg > 0.0:
                    deadline = now + arg
                    self._windows[scope] = deadline
                else:
                    return 0.0
        return max(0.0, deadline - time.monotonic())

    def partition_stall(self, scope: str = "") -> bool:
        """Roll the ``partition`` seam and block out the window —
        the synchronous seam body (agent send path, legacy channel)."""
        remaining = self.partition_window(scope)
        if remaining > 0.0:
            time.sleep(remaining)
        return remaining > 0.0

    def sleep(self, fault: str, scope: str = "") -> bool:
        """Roll and, on a hit, sleep the fault's argument.  Returns
        whether the fault fired — the commonest seam body."""
        arg = self.roll(fault, scope)
        if arg is None:
            return False
        if arg > 0.0:
            time.sleep(arg)
        return True


class _HangWrapper:
    """Picklable body wrapper the agent's ``hang`` seam installs: sleeps
    inside the worker process, then runs the real body — a deterministic
    stand-in for a wedged task."""

    def __init__(self, fn, seconds: float):
        self.fn = fn
        self.seconds = float(seconds)

    def __call__(self, *args, **kwargs):
        time.sleep(self.seconds)
        return self.fn(*args, **kwargs)


# Armed once at import from the environment: agents inherit RJAX_CHAOS
# from the spawning scheduler, so every process in the job sees the same
# spec (each drawing from streams scoped by its own seam names).
INJECTOR: Optional[ChaosInjector] = ChaosInjector.from_env()


def refresh() -> Optional[ChaosInjector]:
    """Re-read ``RJAX_CHAOS`` (tests set the env var mid-process; real
    deployments set it before launch and never need this)."""
    global INJECTOR
    INJECTOR = ChaosInjector.from_env()
    return INJECTOR
