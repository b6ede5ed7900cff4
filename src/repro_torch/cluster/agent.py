"""The node agent: one process per cluster node (DESIGN.md §12).

``python -m repro_torch.cluster.agent --connect HOST:PORT --workers N``

The agent starts ``N`` persistent worker processes (the
:class:`~repro_torch.core.executors.ProcessExecutor` pool in its
synchronous mode — the same shared-memory object plane now serves as the
*intra-node* tier), dials the scheduler once every worker is up,
registers (hello/welcome handshake), and then serves the scheduler's task
stream:

* ``task``  — decode the payload (``Put`` payloads are cached in the
  node-local object plane keyed by ``(data_id, version)``; ``Ref`` markers
  resolve against it — the send-once/reuse-many property), run the body on
  the requested pool slot, reply with the result (ndarrays as raw-codec
  frames, tensors as tensor frames, each tagged with a cache token, or a
  ``RemoteRef`` for a result that stays node-resident) and the counter
  deltas of the pool's reply (kernel launches, device uploads, the
  worker's reserved card bytes).
* ``alias`` — promote a result token to a datum key: the scheduler posts
  this when it publishes the task's output, so later tasks scheduled here
  reference the result without it ever crossing the wire again.
* ``drop``  — discard an unpublished result token.
* ``stats`` — report pool + plane statistics.
* ``exit``  — drain nothing, shut the pool down, leave.

The agent also *pushes* without being asked: a periodic ``hb`` heartbeat
(DESIGN.md §17) rides the same scheduler connection, carrying the node's
plane/pool/p2p telemetry snapshot.  Cadence comes from
``RJAX_HEARTBEAT_S``, then the welcome handshake, then 1s; 0 disables.

The agent never touches the card.  It holds host bytes: a card tensor
from its pool arrives as the process plane's host view (a
:class:`~repro_torch.core.executors.CardResult`) and leaves as a tensor
frame; one from the wire arrives as a ``CardResult`` over the frame and
enters the pool's plane as host bytes.  Only the spawned pool workers make
CUDA contexts, and they rebuild each tensor on the device it lived on.
The workers take the scheduler's torch settings (``--torch-settings``,
which :class:`~repro_torch.cluster.cluster.LocalCluster` passes): its
deterministic-algorithms and TF32 switches, and whether to make their
CUDA context before they report ready.  The ``stats`` answer and the
heartbeat carry the pool's gathered counters and the agent's own
``torch.cuda.is_initialized()`` (``cuda_initialized``).

Failure model: a *pool worker* crash is handled inside the agent (the
inner executor respawns it and the error travels back as a retryable
``WorkerCrashedError``); an *agent* crash surfaces scheduler-side as a
dropped connection, which the cluster executor maps to
``WorkerCrashedError`` and answers by respawning the agent — the
scheduler re-ships whatever data the replacement needs, since v1 keeps
the authoritative copy of every datum on the scheduler.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import queue
import socket
import sys
import threading
import time
import traceback
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.config import add_agent_cli_args, resolve as resolve_knob
from ..core.executors import (
    DeadlineExceededError,
    ProcessExecutor,
    WorkerCrashedError,
    _loads_fn,
)
from ..core.telemetry import HEARTBEAT_DEFAULT_S
from ..core.memory import (
    MemoryBudget,
    MemoryGovernor,
    SpilledValue,
    parse_bytes,
    spill_to_file,
    spillable,
)
from ..core.serialization import as_c_contiguous
from . import chaos
from .peer import PEER_FETCH_TIMEOUT, DataServer, PeerFetchError, PeerPool
from .protocol import (
    DEFAULT_INLINE_MAX,
    ConnectionClosed,
    TENSOR_LEAVES,
    Fetch,
    Frame,
    Put,
    RemoteRef,
    datum_frame_bytes,
    frame_eligible,
    inline_max_from_env,
    recv_msg,
    send_msg,
    struct_nbytes,
    unpack_payload,
    value_frame,
)


class NodePlane:
    """Node-local object cache keyed by ``(data_id, version)``: everything
    this node ever received or produced, so repeat reads never re-cross
    the wire.  Plus a token side-table for results the scheduler has not
    yet bound to a datum key.

    With a memory budget configured (DESIGN.md §13) the plane is bounded:
    cold ndarrays past the high watermark spill to node-local mmap-codec
    files and fault back as zero-copy ``np.memmap`` views on the next
    ``lookup`` — the scheduler keeps sending ``Ref`` markers for them and
    never needs to know.  Entries genuinely *lost* (the whole agent died)
    are re-shipped over the wire by the scheduler's residency reset, which
    is the remote-``Ref`` fault path."""

    def __init__(self, memory_budget=None):
        # reentrant: a governed store() can spill (re-entering plane
        # bookkeeping) while the lock is held
        self._lock = threading.RLock()
        self._data: Dict[Tuple[int, int], Any] = {}
        self._tmp: Dict[int, Any] = {}
        # per-key residency generations (DESIGN.md §20): bumped once per
        # residency *mark* the scheduler ships (Put/Fetch directive,
        # alias, broadcast leg) — the scheduler bumps its mirror ledger
        # at the same message, so after a clean stream both sides agree
        # and a resume manifest entry with a matching generation is valid
        self._gens: Dict[Tuple[int, int], int] = {}
        # keys with a peer fetch in flight (DESIGN.md §15): registered on
        # the reader thread in wire order, resolved by the peer pool;
        # lookups block on the event so a Ref can never observe a gap
        # between the scheduler's residency mark and the bytes landing
        self._pending: Dict[Tuple[int, int], "_PendingFetch"] = {}
        # tombstones for failed pulls: a lookup that starts AFTER the
        # failure must still surface a retryable PeerFetchError (carrying
        # lost_input), not a bare KeyError that burns the task's own
        # retry budget.  Cleared when a fresh Fetch re-registers or the
        # value arrives another way (re-Put after a residency strike)
        self._fetch_failed: Dict[Tuple[int, int], BaseException] = {}
        self.governor: Optional[MemoryGovernor] = None
        self.configure_memory(memory_budget)

    def configure_memory(self, budget, high_frac: float = 0.9,
                         low_frac: float = 0.7) -> None:
        cap = parse_bytes(budget)
        self.governor = None if cap is None else MemoryGovernor(
            MemoryBudget(cap, high_frac, low_frac), self._spill_key,
            name="node-plane")

    def _spill_key(self, key: Tuple[int, int]) -> int:
        value = self._data.get(key)
        if not spillable(value):
            return 0
        try:
            spilled = spill_to_file(
                value, prefix=f"rjax_node_d{key[0]}v{key[1]}_")
        except Exception:
            return 0
        self._data[key] = spilled
        return value.nbytes

    def contains(self, key: Tuple[int, int]) -> bool:
        """Residency probe that never faults (reader-thread pre-store).
        Pending peer fetches count as resident — the bytes are on their
        way, and ``lookup`` blocks until they land."""
        with self._lock:
            return key in self._data or key in self._pending

    def lookup(self, key: Tuple[int, int]) -> Any:
        while True:
            with self._lock:
                if key in self._data:
                    value = self._data[key]
                    if isinstance(value, SpilledValue):
                        view = value.load()   # file-backed: not re-charged
                        self._data[key] = view
                        if self.governor is not None:
                            self.governor.fault(key, value.nbytes)
                        return view
                    if self.governor is not None:
                        self.governor.touch(key)
                    return value
                pending = self._pending.get(key)
                if pending is None:
                    failed = self._fetch_failed.get(key)
            if pending is None:
                if failed is not None:
                    err = PeerFetchError(
                        f"peer fetch of d{key[0]}v{key[1]} failed earlier "
                        f"on this node: {failed}")
                    err.__cause__ = failed
                    raise err
                raise KeyError(key)
            # wait OUTSIDE the lock for the peer pull to land
            if not pending.event.wait(timeout=PEER_FETCH_TIMEOUT):
                raise PeerFetchError(
                    f"peer fetch of d{key[0]}v{key[1]} timed out after "
                    f"{PEER_FETCH_TIMEOUT}s")
            if pending.error is not None:
                raise pending.error

    # -- peer-fetch lifecycle (DESIGN.md §15) --------------------------------
    def begin_fetch(self, key: Tuple[int, int]) -> bool:
        """Register a pending peer pull; False if the key is already
        resident or in flight (nothing to do)."""
        with self._lock:
            if key in self._data or key in self._pending:
                return False
            self._fetch_failed.pop(key, None)   # fresh directive: retry
            self._pending[key] = _PendingFetch()
            return True

    def resolve_fetch(self, key: Tuple[int, int], value: Any) -> None:
        with self._lock:
            self.store(key, value)
            pending = self._pending.pop(key, None)
        if pending is not None:
            pending.event.set()

    def fail_fetch(self, key: Tuple[int, int], err: BaseException) -> None:
        """The pull failed (producer gone).  Current waiters observe the
        error, LATE lookups hit the tombstone (still a retryable
        lost-input error), and a retry's fresh ``Fetch`` directive (after
        the scheduler's residency reset) re-registers cleanly."""
        with self._lock:
            self._fetch_failed[key] = err
            pending = self._pending.pop(key, None)
        if pending is not None:
            pending.error = err
            pending.event.set()

    def lookup_serve(self, key: Optional[Tuple[int, int]],
                     token: Optional[int]) -> Any:
        """Data-server resolution: by datum key first, then by result
        token — a consumer's fetch may legitimately arrive before this
        node processed the ``alias`` that binds token to key."""
        if key is not None:
            try:
                return self.lookup(key)
            except KeyError:
                pass
        with self._lock:
            if token is not None and token in self._tmp:
                return self._tmp[token]
        raise KeyError(key if key is not None else token)

    def store(self, key: Tuple[int, int], value: Any) -> None:
        with self._lock:
            self._data[key] = value
            self._fetch_failed.pop(key, None)   # value arrived after all
            if self.governor is not None and spillable(value):
                self.governor.admit(key, value.nbytes)

    def hold(self, token: int, value: Any) -> None:
        with self._lock:
            self._tmp[token] = value

    def alias(self, token: int, key: Tuple[int, int]) -> None:
        with self._lock:
            v = self._tmp.pop(token, None)
            if v is not None:
                self.store(key, v)

    def drop(self, token: int) -> None:
        with self._lock:
            self._tmp.pop(token, None)

    def note_mark(self, key: Tuple[int, int]) -> int:
        """Bump (and return) the residency generation for ``key`` —
        called once per scheduler residency mark received (§20)."""
        with self._lock:
            g = self._gens.get(key, 0) + 1
            self._gens[key] = g
            return g

    def manifest(self) -> List[Tuple[Tuple[int, int], int, int]]:
        """The resume manifest: ``[(key, generation, nbytes), ...]`` for
        every resident datum (pending fetches excluded — their bytes may
        never land)."""
        with self._lock:
            out = []
            for key, v in self._data.items():
                nb = int(getattr(v, "nbytes", 0) or 0) \
                    if hasattr(v, "nbytes") else struct_nbytes(v)
                out.append((key, self._gens.get(key, 0), nb))
            return out

    def dispose_spills(self) -> None:
        """Unlink still-spilled entries' files (agent shutdown); faulted
        views unlink their own file at GC."""
        with self._lock:
            for key, value in list(self._data.items()):
                if isinstance(value, SpilledValue):
                    value.dispose()
                    del self._data[key]

    def stats(self) -> dict:
        with self._lock:
            vals = list(self._data.values())
            s = {
                "plane_entries": len(vals),
                "plane_tmp": len(self._tmp),
                "plane_pending_fetches": len(self._pending),
                "plane_bytes": sum(struct_nbytes(v) if not hasattr(v, "nbytes")
                                   else int(getattr(v, "nbytes", 0) or 0)
                                   for v in vals),
            }
            if self.governor is not None:
                s.update({f"plane_{k}": v
                          for k, v in self.governor.stats().items()})
            return s


class _PendingFetch:
    __slots__ = ("event", "error")

    def __init__(self):
        self.event = threading.Event()
        self.error: Optional[BaseException] = None


class NodeAgent:
    def __init__(self, address: str, workers: int,
                 node_id: Optional[int] = None,
                 mp_context: Optional[str] = None,
                 memory_budget=None,
                 heartbeat_s=None,
                 inline_max=None,
                 torch_settings: Optional[dict] = None):
        host, _, port = address.rpartition(":")
        self.addr = (host or "127.0.0.1", int(port))
        self.workers = int(workers)
        self.node_id = node_id
        self._mp_context = mp_context
        # the scheduler's torch settings, for the pool workers (None: the
        # workers keep torch's defaults and make no CUDA context up front)
        self.torch_settings = torch_settings
        # every knob resolves through the one precedence rule
        # (core/config.py): CLI flag > this host's env var > the
        # scheduler's welcome value > built-in default.  The welcome
        # tier is filled in by run(); constructor values are the CLI
        # (explicit) tier.
        self.memory_budget = parse_bytes(memory_budget)
        self._heartbeat_cli = None if heartbeat_s is None else float(heartbeat_s)
        self._inline_cli = None if inline_max is None else int(inline_max)
        self.plane = NodePlane()
        self.pool: Optional[ProcessExecutor] = None
        self.sock: Optional[socket.socket] = None
        # peer data plane (DESIGN.md §15): serve our node plane to peers,
        # pull Fetch directives from theirs.  The p2p flag and (unless
        # this host sets RJAX_INLINE_MAX itself) the inline threshold are
        # settled by the welcome handshake, so every agent applies the
        # scheduler's encoding policy
        self.data_server: Optional[DataServer] = None
        self.peers = PeerPool(label=f"agent{node_id}",
                              fd_hooks=(self._track_fd, self._untrack_fd))
        self.p2p = True
        self.heartbeat_s = 0.0   # settled by the welcome handshake
        self.inline_max = inline_max_from_env(self._inline_cli)
        self._send_lock = threading.Lock()
        self._slot_queues: List[queue.Queue] = []
        self._fns: Dict[int, Any] = {}
        self._fn_blobs: Dict[int, bytes] = {}
        self._fn_lock = threading.Lock()
        self._next_token = 1
        self._token_lock = threading.Lock()
        self._done = threading.Event()
        # session resumption (DESIGN.md §20): settled by the welcome
        self._session: Optional[str] = None
        self._grace = 0.0
        self._epoch = 0
        self._last_mid = 0              # highest mid received (serve order)
        self._sent_replies: "OrderedDict[int, tuple]" = OrderedDict()
        self._conn_ok = threading.Event()   # cleared while reconnecting
        self._conn_dead = False
        # per-slot deadline watchdogs (DESIGN.md §19): armed around the
        # pool invoke, they kill the slot's worker when the body overruns
        self._deadline_locks = [threading.Lock() for _ in range(self.workers)]
        self.watchdog_kills = 0

    # ------------------------------------------------------------- lifecycle
    def _track_fd(self, fd: int) -> None:
        """Data-plane sockets (accepted serve connections, outgoing peer
        pulls) must be closed at birth by respawned pool workers, exactly
        like the scheduler socket — a worker inheriting one keeps the
        connection half-open after this agent dies, masking the crash
        from the peer (GIL-atomic list ops; read at fork time)."""
        self.pool.inherit_blockers.append(fd)

    def _untrack_fd(self, fd: int) -> None:
        try:
            self.pool.inherit_blockers.remove(fd)
        except ValueError:
            pass

    def run(self) -> None:
        # fork the pool BEFORE connecting and before the slot threads exist
        # (never fork a multithreaded process, and never let a worker
        # inherit the scheduler socket — a worker holding it would keep
        # the connection half-open after this agent dies, hiding the crash
        # from the scheduler)
        self.pool = ProcessExecutor(self.workers, label="agent",
                                    mp_context=self._mp_context,
                                    settings=self.torch_settings,
                                    build_kernels=False)
        # returns once every worker has reported ready (its CUDA context
        # made, where the settings ask for one): the scheduler hears of
        # this node only then, and a respawned node takes no task before
        self.pool.spawn_workers()
        self.sock = socket.create_connection(self.addr, timeout=30.0)
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # the data listener binds the interface that faces the cluster —
        # the local address of the scheduler connection (127.0.0.1 under
        # LocalCluster: never exposed off-host) — NOT all interfaces:
        # recv_msg unpickles request metadata, so an open port would be a
        # code-execution surface.  Multi-homed deployments where peers
        # live on a different network override with RJAX_DATA_HOST.
        # Binding happens before the hello so the port can ride it.
        data_host = os.environ.get("RJAX_DATA_HOST")
        self.data_server = DataServer(
            self.plane.lookup_serve,
            host=data_host or self.sock.getsockname()[0],
            fd_hooks=(self._track_fd, self._untrack_fd))
        # workers respawned after a crash fork with the socket open: make
        # them close it at birth (the data listener too — a worker holding
        # it would keep serving a dead node's port)
        self.pool.inherit_blockers.append(self.sock.fileno())
        self.pool.inherit_blockers.append(self.data_server._listener.fileno())
        hello = {"op": "hello", "node_id": self.node_id,
                 "workers": self.workers, "pid": os.getpid(),
                 "host": socket.gethostname(),
                 "data_port": self.data_server.port}
        if data_host:
            # explicitly-routed data network: advertise the host too —
            # the default peers derive (this connection's source host)
            # would point at the wrong interface
            hello["data_host"] = data_host
        send_msg(self.sock, hello)
        welcome, _ = recv_msg(self.sock)
        assert welcome.get("op") == "welcome", welcome
        self.node_id = welcome["node_id"]
        self.p2p = bool(welcome.get("p2p", True))
        # session resumption (§20): keep the token; on a transient
        # disconnect we re-dial within the grace window instead of dying
        self._session = welcome.get("session")
        self._grace = max(0.0, float(welcome.get("reconnect_grace_s") or 0.0))
        self._epoch = int(welcome.get("epoch") or 0)
        self._conn_ok.set()
        # CLI > env > welcome > default, uniformly (core/config.py)
        self.heartbeat_s = max(0.0, resolve_knob(
            self._heartbeat_cli, "RJAX_HEARTBEAT_S",
            welcome.get("heartbeat_s"), HEARTBEAT_DEFAULT_S, float))
        self.inline_max = max(0, resolve_knob(
            self._inline_cli, "RJAX_INLINE_MAX",
            welcome.get("inline_max"), DEFAULT_INLINE_MAX, int))
        budget = resolve_knob(
            self.memory_budget, "RJAX_MEMORY_BUDGET",
            welcome.get("memory_budget"), None, parse_bytes)
        if budget is not None:
            # both node-local tiers are governed: the wire-facing plane
            # spills to mmap files, the intra-node shm plane drops
            # segments (their authoritative copy is here or upstream)
            self.plane.configure_memory(budget)
            self.pool.plane.configure_memory(budget)
        self._slot_queues = [queue.Queue() for _ in range(self.workers)]
        threads = []
        for slot in range(self.workers):
            t = threading.Thread(target=self._slot_loop, args=(slot,),
                                 daemon=True, name=f"agent{self.node_id}-s{slot}")
            t.start()
            threads.append(t)
        if self.heartbeat_s > 0:
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name=f"agent{self.node_id}-hb").start()
        try:
            self._serve()
        finally:
            self._done.set()
            for q in self._slot_queues:
                q.put(None)
            for t in threads:
                t.join(timeout=2.0)
            try:
                self.pool.shutdown(wait=False)
            except Exception:
                pass
            try:
                self.peers.close()
            except Exception:
                pass
            try:
                self.data_server.close()
            except Exception:
                pass
            try:
                self.plane.dispose_spills()
            except Exception:
                pass
            try:
                self.sock.close()
            except OSError:
                pass

    def _serve(self) -> None:
        while True:
            try:
                meta, frames = recv_msg(self.sock)
            except ConnectionClosed:
                # scheduler link dropped: resume the session within the
                # grace window (§20), else exit and let respawn happen
                if self._try_resume():
                    continue
                return
            mid = meta.get("mid")
            if mid is not None and mid > self._last_mid:
                # the resume hello reports this high-water mark so the
                # scheduler knows which in-flight requests we ever saw
                self._last_mid = mid
            op = meta.get("op")
            if op == "task":
                # pre-store Puts and the fn blob HERE, on the reader, before
                # the task is even queued: slot threads run concurrently, so
                # the scheduler's wire-FIFO residency guarantee (a Ref never
                # overtakes its Put; an fn token never beats its body) must
                # be anchored at the single in-order consumer of the stream
                try:
                    self._pre_store(meta, frames)
                except Exception as err:   # malformed payload: fail the task,
                    import traceback       # not the whole agent
                    self._reply({"op": "err", "mid": meta.get("mid"),
                                 "exc": None,
                                 "tb": f"{type(err).__name__}|{err}|"
                                       f"{traceback.format_exc()}"})
                    continue
                self._slot_queues[meta["slot"]].put((meta, frames))
            elif op == "alias":
                key = tuple(meta["key"])
                self.plane.note_mark(key)
                self.plane.alias(meta["token"], key)
            elif op == "bcast":
                self._handle_bcast(meta, frames)
            elif op == "drop":
                self.plane.drop(meta["token"])
            elif op == "stats":
                # the on-demand answer also names the pool plane's
                # segments, so a caller can check /dev/shm after a stop
                stats = self._telemetry_stats()
                stats["segment_names"] = self.pool.plane.names()
                self._reply({"op": "stats", "mid": meta["mid"], "stats": stats})
            elif op == "exit":
                return
            else:
                self._reply({"op": "err", "mid": meta.get("mid"), "exc": None,
                             "tb": f"agent: unknown op {op!r}"})

    _REPLAY_RING = 256   # recorded replies kept for resume replay

    @property
    def _resume_enabled(self) -> bool:
        return bool(self._session) and self._grace > 0

    def _record_reply(self, mid: int, meta: dict, frames) -> None:
        # caller holds _send_lock.  Bounded: entries reference plane-held
        # buffers, so the ring itself costs little extra memory, but it
        # must not grow with job length
        ring = self._sent_replies
        ring[mid] = (meta, frames)
        ring.move_to_end(mid)
        while len(ring) > self._REPLAY_RING:
            ring.popitem(last=False)

    def _reply(self, meta: dict, frames=()) -> None:
        """Send a reply/push to the scheduler.  With session resumption
        armed, a mid-carrying reply survives a transient disconnect: it
        is recorded in the replay ring and the send retried once the
        serve loop has swapped in the resumed socket (§20)."""
        mid = meta.get("mid")
        retryable = mid is not None and self._resume_enabled
        while True:
            if not self._conn_ok.wait(timeout=self._grace + 5.0):
                raise ConnectionClosed("scheduler connection not restored")
            if self._conn_dead:
                raise ConnectionClosed("scheduler gone")
            try:
                with self._send_lock:
                    inj = chaos.INJECTOR
                    if inj is not None:
                        # chaos seam (§19/§20): the node's uplink is
                        # partitioned — every outbound message stalls
                        inj.partition_stall(f"agent{self.node_id}-wire")
                    if retryable:
                        self._record_reply(mid, meta, frames)
                    send_msg(self.sock, meta, frames)
                return
            except (ConnectionClosed, OSError) as err:
                if not retryable:
                    raise ConnectionClosed(str(err) or "send failed") from err
                # the serve loop's recv fails too and drives the
                # reconnect; wait for the swapped socket and retry
                self._conn_ok.clear()

    # -------------------------------------------- session resumption (§20)
    def _try_resume(self) -> bool:
        """Re-dial the scheduler and resume this session after a
        transient disconnect.  Returns True with ``self.sock`` swapped to
        the accepted resume connection, or False (grace exhausted,
        session rejected, or resumption disabled) — the caller then exits
        and the scheduler's respawn path takes over."""
        if not self._resume_enabled or self._done.is_set():
            return False
        self._conn_ok.clear()
        self._epoch += 1
        deadline = time.monotonic() + self._grace + 2.0
        delay = 0.05
        while time.monotonic() < deadline and not self._done.is_set():
            sock = None
            try:
                sock = socket.create_connection(self.addr, timeout=5.0)
                try:
                    sock.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                hello = {"op": "hello", "resume": self._session,
                         "epoch": self._epoch, "node_id": self.node_id,
                         "workers": self.workers, "pid": os.getpid(),
                         "host": socket.gethostname(),
                         "data_port": self.data_server.port,
                         "seen_mid": self._last_mid,
                         "manifest": self.plane.manifest()}
                data_host = os.environ.get("RJAX_DATA_HOST")
                if data_host:
                    hello["data_host"] = data_host
                send_msg(sock, hello)
                sock.settimeout(10.0)
                welcome, _ = recv_msg(sock)
                sock.settimeout(None)
            except (OSError, ConnectionClosed):
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                time.sleep(delay)
                delay = min(delay * 2, 0.5)
                continue
            if not welcome.get("resumed"):
                # session superseded or grace expired scheduler-side:
                # this process is dead weight, the respawn owns the node
                try:
                    sock.close()
                except OSError:
                    pass
                break
            with self._send_lock:
                old, self.sock = self.sock, sock
            # fd hygiene: respawned pool workers must close the NEW
            # scheduler socket at birth, and stop blocking on the old fd
            old_fd = -1
            try:
                old_fd = old.fileno()
            except OSError:
                pass
            self.pool.inherit_blockers.append(sock.fileno())
            self._untrack_fd(old_fd)
            try:
                old.close()
            except OSError:
                pass
            self._replay(welcome.get("outstanding") or ())
            self._conn_ok.set()
            return True
        self._conn_dead = True
        self._conn_ok.set()   # wake blocked repliers so they fail fast
        return False

    def _replay(self, outstanding) -> None:
        """Re-send recorded replies for still-outstanding mids: the
        first copy may have died in the old socket's buffers.  The
        scheduler ignores a mid it has already completed."""
        with self._send_lock:
            for mid in outstanding:
                entry = self._sent_replies.get(mid)
                if entry is None:
                    continue   # task still executing: reply comes later
                try:
                    send_msg(self.sock, entry[0], entry[1])
                except (ConnectionClosed, OSError):
                    return

    # ------------------------------------------------------------- telemetry
    def _telemetry_stats(self) -> dict:
        """One node telemetry snapshot: plane ledger + pool counters +
        p2p fetch ledger + data-server stats + queued task depth.  Served
        on demand (``stats``) and pushed periodically (``hb``)."""
        s = dict(self.plane.stats())
        # the inner pool's shm plane reports its own governor under
        # plane_* too: namespace it so the node plane's ledger (the
        # wire-facing tier) isn't shadowed
        for k, v in self.pool.stats().items():
            s[f"pool_{k}" if (k in s or k.startswith("plane_"))
              else k] = v
        s["node_id"] = self.node_id
        # the pool is the single fetch ledger (counted where both
        # sync and async pulls converge, under the pool lock)
        s["p2p_fetches"] = self.peers.fetches
        s["p2p_fetch_bytes"] = self.peers.fetch_bytes
        if self.data_server is not None:
            s.update(self.data_server.stats())
        # in-flight credit depth: tasks the scheduler streamed ahead that
        # are still waiting for a pool slot (DESIGN.md §14/§17)
        s["queued"] = sum(q.qsize() for q in self._slot_queues)
        s["watchdog_kills"] = self.watchdog_kills
        # the agent holds host bytes only: this stays False
        s["cuda_initialized"] = torch.cuda.is_initialized()
        return s

    def _heartbeat_loop(self) -> None:
        """Push the telemetry snapshot every ``heartbeat_s`` seconds on
        the scheduler connection.  No ``mid``: nothing awaits it — the
        scheduler's channel reader routes mid-less messages to its
        ``on_push`` hook (DESIGN.md §17).  Dies silently with the
        connection; the respawned agent starts a fresh loop.  Beats
        immediately so the scheduler's node view populates at startup
        rather than one cadence later."""
        while True:
            inj = chaos.INJECTOR
            if inj is not None and inj.roll("drop",
                                            f"agent{self.node_id}-hb") is not None:
                # chaos seam: heartbeat loss — the beat is simply never
                # sent; enough consecutive drops and the scheduler's
                # failure detector declares this node dead
                if self._done.wait(self.heartbeat_s):
                    return
                continue
            try:
                self._reply({"op": "hb", "node": self.node_id,
                             "t": time.time(),
                             "stats": self._telemetry_stats()})
            except (ConnectionClosed, OSError):
                if not self._resume_enabled or self._conn_dead:
                    return
                # reconnecting: skip this beat, keep the loop alive —
                # the resumed session needs heartbeats or the failure
                # detector would declare the node dead post-resume
            if self._done.wait(self.heartbeat_s):
                return

    # ------------------------------------------------------------- broadcast
    def _handle_bcast(self, meta: dict, frames) -> None:
        """One leg of a collective broadcast (DESIGN.md §16).  The *root*
        form (``root=True``) carries the datum's encoded structure +
        frames over the scheduler link: store into the plane and ack.
        The *peer* form carries a parent agent's data-plane address
        instead: pull the bytes agent→agent through the peer pool and
        ack once they land — the ack is what promotes this node to a
        source for the next frontier wave.  Acks are asynchronous; the
        reader thread never blocks on a pull."""
        key = tuple(meta["key"])
        mid = meta["mid"]
        self.plane.note_mark(key)

        def ack():
            try:
                self._reply({"op": "bcast_ok", "mid": mid,
                             "node": self.node_id})
            except ConnectionClosed:
                pass

        def nak(err):
            try:
                enc = pickle.dumps(err, protocol=5)
            except Exception:
                enc = None
            try:
                self._reply({"op": "err", "mid": mid, "exc": enc,
                             "tb": f"{type(err).__name__}|{err}"})
            except ConnectionClosed:
                pass

        if meta.get("root"):
            if not self.plane.contains(key):
                self.plane.store(key, unpack_payload(meta["structure"],
                                                     frames))
            ack()
            return

        if not self.plane.begin_fetch(key):
            # already resident or a pull is in flight: confirm from a
            # side thread (lookup may block on the pending entry)
            def confirm():
                try:
                    self.plane.lookup(key)
                    ack()
                except BaseException as err:  # noqa: BLE001 — ships back
                    nak(err)

            threading.Thread(target=confirm, daemon=True,
                             name=f"agent{self.node_id}-bcast").start()
            return

        addr = meta.get("addr")
        if not addr:
            err = PeerFetchError(
                f"no data-plane address for broadcast parent of "
                f"d{key[0]}v{key[1]}")
            self.plane.fail_fetch(key, err)
            nak(err)
            return

        def on_done(value, err):
            if err is not None:
                self.plane.fail_fetch(key, err)
                nak(err)
            else:
                self.plane.resolve_fetch(key, value)
                ack()

        self.peers.fetch_async(addr, key, meta.get("token"), on_done)

    # ------------------------------------------------------------- task path
    def _pre_store(self, meta: dict, frames) -> None:
        """Reader-thread half of a task message: pin the fn blob, cache
        every ``Put`` payload into the plane (frame decode is a zero-copy
        ``np.frombuffer``, so this stays cheap), and kick off the peer
        pull for every ``Fetch`` directive (registered here, in stream
        order, so a later ``Ref`` to the same key blocks on the pending
        entry instead of missing).  Runs for every task whether or not
        the body later fails — keeping the scheduler's residency/fn
        ledgers truthful."""
        blob = meta.get("fn")
        if blob:
            with self._fn_lock:
                self._fn_blobs.setdefault(meta["token"], blob)

        def walk(o):
            if isinstance(o, Put):
                # generation bump regardless of the contains-skip: the
                # scheduler bumped its mirror when it *sent* the mark
                self.plane.note_mark(o.key)
                if not self.plane.contains(o.key):   # probe, don't fault
                    # a Put payload is the datum's structure with Frame
                    # markers only (enc_value never nests other datums),
                    # so the protocol's own walker decodes it
                    self.plane.store(o.key, unpack_payload(o.value, frames))
            elif isinstance(o, Fetch):
                self.plane.note_mark(o.key)
                if self.plane.begin_fetch(o.key):
                    self._start_fetch(o)
            elif isinstance(o, (list, tuple)):
                for x in o:
                    walk(x)
            elif isinstance(o, dict):
                for x in o.values():
                    walk(x)

        walk(meta["structure"])

    def _start_fetch(self, directive: Fetch) -> None:
        """Queue the peer pull on the pooled per-peer connection; the
        callback lands the value in the plane (or fails current waiters)."""
        key = tuple(directive.key)
        if not directive.addr:
            # a channel without a derivable peer address (e.g. a
            # socketpair harness) can book RemoteValues with addr=None;
            # fail the pull cleanly instead of wedging the reader thread
            self.plane.fail_fetch(key, PeerFetchError(
                f"no data-plane address for node {directive.node} "
                f"(d{key[0]}v{key[1]})"))
            return

        def on_done(value, err):
            if err is not None:
                self.plane.fail_fetch(key, err)
                return
            self.plane.resolve_fetch(key, value)

        self.peers.fetch_async(directive.addr, key, directive.token, on_done)

    def _fn_for(self, token: int):
        with self._fn_lock:
            fn = self._fns.get(token)
            if fn is None:
                blob = self._fn_blobs.get(token)
                if not blob:
                    raise RuntimeError(f"fn token {token} unknown and no body sent")
                fn = _loads_fn(blob)
                self._fns[token] = fn
            return fn

    # -- deadline watchdog (DESIGN.md §19) -----------------------------------
    def _arm_deadline(self, slot: int, seconds: float) -> dict:
        """Start a timer that kills this slot's pool worker if the task
        body runs past ``seconds``.  The kill only terminates the process
        — no respawn here: the blocked ``pool.invoke`` observes the EOF
        and performs the single restart, so there is exactly one respawn
        owner and no double-restart race."""
        state = {"fired": False, "active": True}
        lock = self._deadline_locks[slot]

        def fire():
            with lock:
                if not state["active"]:
                    return
                state["fired"] = True
                self.watchdog_kills += 1
                try:
                    self.pool.kill_worker(slot)
                except Exception:
                    pass

        timer = threading.Timer(seconds, fire)
        timer.daemon = True
        state["timer"] = timer
        timer.start()
        return state

    def _disarm_deadline(self, slot: int, state: dict) -> bool:
        """Cancel the watchdog; returns whether it already fired (the
        fire/kill runs under the slot lock, so after this returns False
        no kill can happen)."""
        with self._deadline_locks[slot]:
            state["active"] = False
        state["timer"].cancel()
        return state["fired"]

    def _invoke_with_deadline(self, slot: int, deadline_s: float, fn,
                              args, kwargs, keyed):
        state = self._arm_deadline(slot, deadline_s)
        try:
            result = self.pool.invoke(slot, fn, args, kwargs,
                                      input_keys=keyed)
        except WorkerCrashedError as err:
            if self._disarm_deadline(slot, state):
                raise DeadlineExceededError(
                    f"task exceeded its deadline of {deadline_s}s on node "
                    f"{self.node_id} slot {slot} (worker killed)") from err
            raise
        self._disarm_deadline(slot, state)
        return result

    def _slot_loop(self, slot: int) -> None:
        while not self._done.is_set():
            item = self._slot_queues[slot].get()
            if item is None:
                return
            meta, frames = item
            mid = meta["mid"]
            try:
                fn = self._fn_for(meta["token"])
                inj = chaos.INJECTOR
                if inj is not None:
                    # chaos seam: a wedged worker — the sleep runs INSIDE
                    # the pool worker, so only a deadline can unwedge it
                    hang = inj.roll("hang", f"agent{self.node_id}-s{slot}")
                    if hang is not None:
                        fn = chaos._HangWrapper(fn, hang)
                keyed: Dict[int, Tuple[int, int]] = {}
                args, kwargs = unpack_payload(meta["structure"], frames,
                                              lookup=self.plane.lookup,
                                              store=self.plane.store)
                # keyed inputs enter the *intra-node* shm plane under the
                # same (data_id, version), extended by each array or
                # tensor leaf's path, deduping across pool workers
                for marker_key, v in _keyed_datums(meta["structure"], self.plane):
                    keyed[id(v)] = marker_key
                deadline_s = meta.get("deadline_s")
                t_body = time.perf_counter()
                if deadline_s is not None:
                    result = self._invoke_with_deadline(
                        slot, float(deadline_s), fn, args, kwargs, keyed)
                else:
                    result = self.pool.invoke(slot, fn, args, kwargs,
                                              input_keys=keyed)
                # body seconds, free of queue/dispatch latency — the
                # scheduler's replication cost bar (DESIGN.md §20) needs
                # the true producer cost, not its pipeline wait
                dur = time.perf_counter() - t_body
                structure, out_frames, tokens = self._encode_result(
                    result, meta.get("n_out", -1))
                if inj is not None:
                    # chaos seam: a node draining slowly — reply latency
                    inj.sleep("stall", f"agent{self.node_id}-reply")
                self._reply({"op": "done", "mid": mid, "structure": structure,
                             "tokens": tokens, "dur": round(dur, 6),
                             "counters": self.pool.last_counters()},
                            out_frames)
            except BaseException as err:  # noqa: BLE001 — ships to scheduler
                tb = traceback.format_exc()
                try:
                    enc = pickle.dumps(err, protocol=5)
                except Exception:
                    enc = None
                try:
                    self._reply({"op": "err", "mid": mid, "exc": enc,
                                 "tb": f"{type(err).__name__}|{err}|{tb}",
                                 "counters": self.pool.last_counters()})
                except ConnectionClosed:
                    return
            finally:
                self.pool.task_done()   # reclaim unpublished result segments

    def _new_token(self) -> int:
        with self._token_lock:
            token = self._next_token
            self._next_token += 1
            return token

    def _encode_result(self, result: Any, n_out: int = -1):
        """Encode a ``done`` reply (DESIGN.md §15).

        ``n_out`` is the task's declared output count, which tells us
        which positions of the result are whole *datums*: the root when
        ``n_out <= 1``, the top-level elements when the result is an
        ``n_out``-tuple.  A datum whose frame-eligible bytes reach the
        inline threshold stays HERE, in the token side-table, and the
        reply carries only a ``RemoteRef`` descriptor — the scheduler
        books a ``RemoteValue`` and consumers pull peer-to-peer.  Datums
        below the threshold (``RJAX_INLINE_MAX``) ride the reply inline:
        no token, no alias round-trip (a tensor still rides a frame of its
        own, untokened: tensors are never pickled).  Arrays that are not
        at a datum position (or when p2p is off) keep the frame+token path
        so a later ``alias`` can still pin them."""
        frames: List = []
        tokens: List[Optional[int]] = []

        def enc(o: Any) -> Any:
            wired = isinstance(o, np.ndarray) or isinstance(o, TENSOR_LEAVES)
            if wired and frame_eligible(o, self.inline_max):
                token = self._new_token()
                if isinstance(o, np.ndarray):
                    o = as_c_contiguous(o)
                self.plane.hold(token, o)
                frames.append(value_frame(o))
                tokens.append(token)
                return Frame(len(frames) - 1)
            if isinstance(o, TENSOR_LEAVES):
                frames.append(value_frame(o))
                tokens.append(None)
                return Frame(len(frames) - 1)
            if isinstance(o, (list, tuple)):
                mapped = [enc(x) for x in o]
                if isinstance(o, tuple):
                    return type(o)(*mapped) if hasattr(o, "_fields") else tuple(mapped)
                return mapped
            if isinstance(o, dict):
                return {k: enc(v) for k, v in o.items()}
            return o

        def enc_datum(o: Any) -> Any:
            if self.p2p:
                nbytes = datum_frame_bytes(o)
                if nbytes >= max(1, self.inline_max):
                    if isinstance(o, np.ndarray):
                        o = as_c_contiguous(o)
                    token = self._new_token()
                    self.plane.hold(token, o)
                    return RemoteRef(token, nbytes)
            return enc(o)

        if n_out > 1 and isinstance(result, (tuple, list)) \
                and len(result) == n_out:
            mapped = [enc_datum(el) for el in result]
            structure: Any = tuple(mapped) if isinstance(result, tuple) \
                else mapped
        else:
            structure = enc_datum(result)
        return structure, frames, tokens


def _keyed_datums(structure, plane):
    """Yield ``(key, value)`` for every keyed datum the decoded payload
    contains (fresh ``Put``s, plane-resident ``Ref``s and peer-pulled
    ``Fetch``es), so the inner pool's shm plane can dedup its leaves by
    datum key: the pool keys every array or tensor leaf of a datum (a
    fragment ``(X, y)`` too) by the datum key extended by the leaf's
    path, as the process backend does."""
    from .protocol import Fetch, Put, Ref

    out = []

    def walk(o):
        if isinstance(o, (Ref, Put, Fetch)):
            out.append((o.key, plane.lookup(o.key)))
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        elif isinstance(o, dict):
            for x in o.values():
                walk(x)

    walk(structure)
    return out


# ------------------------------------------------------------------------ CLI
def build_arg_parser() -> argparse.ArgumentParser:
    """The agent CLI: topology flags here, every tunable knob mirrored
    from :class:`repro_torch.core.config.RuntimeConfig` (one source of
    truth for flag/env/welcome precedence — the flag is the explicit
    tier)."""
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.cluster.agent",
        description="RJAX cluster node agent: connect to a scheduler and "
                    "serve tasks on a local pool of persistent worker "
                    "processes.")
    p.add_argument("--connect", required=True, metavar="HOST:PORT",
                   help="scheduler address to register with")
    p.add_argument("--workers", type=int, default=2,
                   help="worker processes in this node's pool (default 2)")
    p.add_argument("--node-id", type=int, default=None,
                   help="node ordinal (assigned by the scheduler if omitted)")
    p.add_argument("--torch-settings", type=json.loads, default=None,
                   metavar="JSON",
                   help="the scheduler's torch settings for the pool workers, as "
                        "JSON (deterministic algorithms, TF32 switches, whether to "
                        "make a CUDA context before reporting ready)")
    add_agent_cli_args(p)   # --memory-budget / --mp-context / --inline-max
    return p                # / --heartbeat-s, docs from RuntimeConfig


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)

    # SIGTERM's default action skips all cleanup, which would orphan the
    # daemon pool workers (they inherit pipes/stdio and can linger
    # forever).  Raise SystemExit instead so ``run()``'s finally block
    # shuts the pool down politely.
    import signal

    def _terminate(signum, frame):
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _terminate)

    agent = NodeAgent(args.connect, args.workers, node_id=args.node_id,
                      mp_context=args.mp_context,
                      memory_budget=args.memory_budget,
                      heartbeat_s=args.heartbeat_s,
                      inline_max=args.inline_max,
                      torch_settings=args.torch_settings)
    try:
        agent.run()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
