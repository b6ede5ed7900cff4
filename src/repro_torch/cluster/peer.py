"""Peer-to-peer data plane: node-resident results move agent↔agent
(DESIGN.md §15).

Every node agent runs a :class:`DataServer` — a tiny TCP listener on an
ephemeral port (advertised in the hello/welcome handshake) that serves
``fetch`` requests straight out of the agent's node plane.  Consumers —
other agents resolving a ``Fetch`` directive, or the scheduler
materializing a gather — pull through a :class:`PeerPool`: one pooled,
persistent connection per peer with a dedicated sender thread, so
requests to a given peer are strictly FIFO (the per-peer ordering that
keeps Put-before-Ref residency reasoning intact) and connection setup is
paid once, not per datum.

Wire format is the cluster protocol's length-prefixed framing
(:mod:`repro_torch.cluster.protocol`): a fetch request is one metadata
frame, the reply is the datum's structure with its ndarrays as raw-codec
frames and its tensors as tensor frames (zero-copy on both sides, same as
task payloads).  Peers exchange host bytes only: a tensor that lived on a
card arrives as a :class:`~repro_torch.core.executors.CardResult`, and
only a process that reads it uploads it.

Failure model: a dead producer surfaces as :class:`PeerFetchError`, a
subclass of the retryable
:class:`~repro_torch.core.executors.WorkerCrashedError` — the scheduler
answers by re-executing the producer from graph lineage and retrying the
consumer (see ``Runtime.recover_lost_node``).
"""
from __future__ import annotations

import os
import queue
import socket
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from ..core.executors import WorkerCrashedError
from . import chaos
from .protocol import (
    ConnectionClosed,
    pack_payload,
    recv_msg,
    send_msg,
    struct_nbytes,
    unpack_payload,
)

# how long a fetch may sit on a peer's wire before the consumer gives up
# (covers a wedged-but-connected producer — a half-open connection after
# a partition or freeze never EOFs, so this timeout is the ONLY thing
# standing between the consumer and blocking forever; a dead producer
# fails fast on connect/EOF).  Read at call time so tests can tighten it.
PEER_FETCH_TIMEOUT = float(os.environ.get("RJAX_PEER_FETCH_TIMEOUT", 60.0))


def _fetch_timeout() -> float:
    """The effective peer-fetch timeout — module attribute lookup at call
    time, so monkeypatching ``peer.PEER_FETCH_TIMEOUT`` (the half-open
    tests) takes effect without re-importing."""
    return PEER_FETCH_TIMEOUT


class PeerFetchError(WorkerCrashedError):
    """A peer-to-peer pull failed (producer down, datum gone).  Retryable:
    the scheduler re-executes the producer from lineage.

    ``lost_input`` marks this as an *input* loss, not a failure of the
    task's own execution: the runtime grants such failures a bounded
    retry allowance beyond the task's ``max_retries`` — pre-§15 a crash
    after the producer completed could never hurt consumers (the bytes
    were already on the scheduler), and the default ``max_retries=0``
    must not regress that."""

    lost_input = True


def encode_value(value: Any):
    """One datum as ``(structure, frames)`` for a data-plane reply —
    ``pack_payload`` with no keys, so inner arrays ride raw-codec
    frames, tensors ride tensor frames and everything else pickles."""
    structure, frames, _ = pack_payload(value)
    return structure, frames


def decode_value(structure: Any, frames) -> Any:
    return unpack_payload(structure, frames)


class DataServer:
    """Serves this node's plane to peers.  ``lookup(key, token)`` is
    supplied by the agent: resolve by datum key first, then by result
    token (covers the window where a consumer's fetch beats the
    producer's ``alias`` control message — cross-channel ordering is not
    guaranteed, which is exactly why fetch requests carry both)."""

    def __init__(self, lookup: Callable[[Tuple[int, int], Optional[int]], Any],
                 host: str = "127.0.0.1",
                 fd_hooks: Optional[Tuple[Callable, Callable]] = None):
        self._lookup = lookup
        # (track, untrack) callbacks keeping the owner's fork-time
        # close-fd list current: a pool worker forked while a data-plane
        # connection is open would otherwise inherit it and keep the
        # peer's socket half-open after this agent dies — masking the
        # crash from consumers (the §12 fd-hygiene invariant)
        self._fd_track, self._fd_untrack = fd_hooks or (None, None)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, 0))
        self._listener.listen(64)
        self.port = self._listener.getsockname()[1]
        self._closed = False
        self._conns: Dict[int, socket.socket] = {}
        self._lock = threading.Lock()
        self.serves = 0
        self.served_bytes = 0
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="data-accept")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return   # listener closed
            try:
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns[conn.fileno()] = conn
            if self._fd_track is not None:
                self._fd_track(conn.fileno())
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True, name="data-serve").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        fd = conn.fileno()
        try:
            while True:
                try:
                    meta, _ = recv_msg(conn)
                except ConnectionClosed:
                    return   # peer hung up (pool teardown)
                if meta.get("op") != "fetch":
                    send_msg(conn, {"op": "data", "ok": False,
                                    "error": f"unknown op {meta.get('op')!r}"})
                    continue
                # chaos seam (DESIGN.md §19): half-open freeze — the
                # request was accepted but no reply ever comes (what a
                # network partition leaves behind).  The consumer's
                # PEER_FETCH_TIMEOUT must turn this into a retryable
                # PeerFetchError; parking the serving thread (rather
                # than closing) is the point — no EOF, no on_close.
                inj = chaos.INJECTOR
                if inj is not None and inj.roll("freeze", "data-serve") is not None:
                    while not self._closed:
                        time.sleep(0.05)
                    return
                key = tuple(meta["key"]) if meta.get("key") else None
                token = meta.get("token")
                try:
                    value = self._lookup(key, token)
                    structure, frames = encode_value(value)
                except KeyError:
                    send_msg(conn, {"op": "data", "ok": False,
                                    "error": f"datum {key} (token {token}) "
                                             "not resident"})
                    continue
                except ConnectionClosed:
                    raise
                except Exception as err:
                    send_msg(conn, {"op": "data", "ok": False,
                                    "error": f"{type(err).__name__}: {err}"})
                    continue
                send_msg(conn, {"op": "data", "ok": True,
                                "structure": structure}, frames)
                nbytes = sum(sum(len(p) for p in f) for f in frames)
                with self._lock:   # one serving thread per connection
                    self.serves += 1
                    self.served_bytes += nbytes
        except (ConnectionClosed, OSError):
            pass
        finally:
            with self._lock:
                self._conns.pop(fd, None)
            if self._fd_untrack is not None:
                self._fd_untrack(fd)
            try:
                conn.close()
            except OSError:
                pass

    def stats(self) -> dict:
        return {"p2p_serves": self.serves, "p2p_served_bytes": self.served_bytes}

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class _FetchJob:
    __slots__ = ("key", "token", "callback")

    def __init__(self, key, token, callback):
        self.key = key
        self.token = token
        self.callback = callback


class _Peer:
    """One pooled connection to a peer's data server, with a dedicated
    sender thread draining a FIFO of fetch jobs — per-peer ordering."""

    def __init__(self, addr: str, label: str, pool: "PeerPool" = None):
        host, _, port = addr.rpartition(":")
        self.addr = addr
        self._pool = pool
        self._sockaddr = (host or "127.0.0.1", int(port))
        self._q: "queue.Queue[Optional[_FetchJob]]" = queue.Queue()
        self._sock: Optional[socket.socket] = None
        # dead-flag and queue share one lock so a job can never be
        # enqueued AFTER the close sentinel: either it lands ahead of the
        # sentinel (and is processed/failed normally) or submit() returns
        # False and the pool retries with a fresh peer.  A job silently
        # stranded behind the sentinel would never fire its callback —
        # permanently wedging the consumer plane's pending-fetch entry
        self._dead = False
        self._retired = False   # connection-level failure seen (loop-local)
        self._state_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name=f"{label}-peer-{addr}")
        self._thread.start()

    def submit(self, job: _FetchJob) -> bool:
        with self._state_lock:
            if self._dead:
                return False
            self._q.put(job)
            return True

    def _connect(self) -> socket.socket:
        sock = socket.create_connection(self._sockaddr, timeout=10.0)
        sock.settimeout(_fetch_timeout())
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        if self._pool is not None and self._pool.fd_track is not None:
            self._pool.fd_track(sock.fileno())
        return sock

    def _close_sock(self) -> None:
        if self._sock is None:
            return
        if self._pool is not None and self._pool.fd_untrack is not None:
            try:
                self._pool.fd_untrack(self._sock.fileno())
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    def _loop(self) -> None:
        while True:
            job = self._q.get()
            if job is None:
                self._close_sock()
                return
            value, error = None, None
            try:
                if self._retired:
                    # a connection-level failure already retired this
                    # peer: jobs queued behind the failure must not each
                    # pay a fresh connect timeout to the dead address —
                    # fail them immediately into the retry/lineage path
                    raise PeerFetchError(
                        f"peer {self.addr} is gone (connection lost before "
                        f"d{job.key[0]}v{job.key[1]} was served)")
                if self._sock is None:
                    self._sock = self._connect()
                # chaos seam (DESIGN.md §19): congested data plane —
                # added latency ahead of the pull request
                inj = chaos.INJECTOR
                if inj is not None:
                    inj.sleep("fetch-slow", f"peer-{self.addr}")
                send_msg(self._sock, {"op": "fetch", "key": job.key,
                                      "token": job.token})
                meta, frames = recv_msg(self._sock)
                if not meta.get("ok"):
                    raise PeerFetchError(
                        f"peer {self.addr} cannot serve d{job.key[0]}"
                        f"v{job.key[1]}: {meta.get('error')}")
                value = decode_value(meta["structure"], frames)
            except PeerFetchError as err:
                error = err
            except Exception as err:
                # connection-level failure: drop the socket, and retire
                # this pooled peer entirely — a dead producer never comes
                # back on the same ephemeral port, so keeping the entry
                # would leak one parked sender thread per crash (a later
                # fetch_async to the same addr simply pools a fresh peer)
                self._close_sock()
                self._retired = True
                if self._pool is not None:
                    self._pool._evict(self.addr, self)
                error = PeerFetchError(
                    f"peer fetch of d{job.key[0]}v{job.key[1]} from "
                    f"{self.addr} failed: {type(err).__name__}: {err}")
                error.__cause__ = err
            if error is None and self._pool is not None:
                self._pool.note_fetched(struct_nbytes(value))
            # a raising callback (e.g. a spill dir hitting ENOSPC inside
            # the consumer plane's store) must not kill the ONLY sender
            # thread for this peer — that would strand every queued and
            # future fetch with no reconnect path
            try:
                job.callback(value, error)
            except BaseException:
                import traceback
                traceback.print_exc()

    def close(self) -> None:
        with self._state_lock:
            self._dead = True
            self._q.put(None)


class PeerPool:
    """Pooled peer connections keyed by ``host:port`` data-plane address."""

    def __init__(self, label: str = "rjax",
                 fd_hooks: Optional[Tuple[Callable, Callable]] = None):
        self._label = label
        self._lock = threading.Lock()
        self._peers: Dict[str, _Peer] = {}
        self._closed = False
        self.fd_track, self.fd_untrack = fd_hooks or (None, None)
        self.fetches = 0
        self.fetch_bytes = 0

    def _peer(self, addr: str) -> Optional[_Peer]:
        with self._lock:
            if self._closed:
                return None
            p = self._peers.get(addr)
            if p is None:
                p = self._peers[addr] = _Peer(addr, self._label, pool=self)
            return p

    def note_fetched(self, nbytes: int) -> None:
        """Ledger hook for the per-peer sender threads (locked: several
        peers complete concurrently and a bare ``+=`` loses updates)."""
        with self._lock:
            self.fetches += 1
            self.fetch_bytes += int(nbytes)

    def _evict(self, addr: str, peer: _Peer) -> None:
        """A peer's connection died: retire it (its sender thread exits
        once the queued jobs have been failed through their callbacks)."""
        with self._lock:
            if self._peers.get(addr) is peer:
                del self._peers[addr]
        peer.close()

    def fetch_async(self, addr: str, key, token,
                    callback: Callable[[Any, Optional[BaseException]], None]
                    ) -> None:
        """Queue a pull; ``callback(value, error)`` fires on the peer's
        sender thread (exactly once).  A peer retired by a concurrent
        eviction refuses the job; loop for a fresh one (bounded — a new
        _Peer accepts at least its first job before it can die)."""
        job = _FetchJob(tuple(key), token, callback)
        while True:
            peer = self._peer(addr)
            if peer is None:
                # pool closed (executor shutdown racing a straggler
                # gather): fail the job instead of pooling a peer whose
                # sender thread nobody would ever close
                callback(None, PeerFetchError(
                    f"peer pool closed; cannot fetch "
                    f"d{job.key[0]}v{job.key[1]} from {addr}"))
                return
            if peer.submit(job):
                return
            # raced an eviction: drop the stale mapping if still present
            with self._lock:
                if self._peers.get(addr) is peer:
                    del self._peers[addr]

    def fetch(self, addr: str, key, token,
              timeout: Optional[float] = None) -> Any:
        """Synchronous pull (the scheduler's gather path).  ``timeout``
        defaults to the effective ``PEER_FETCH_TIMEOUT`` at call time."""
        if timeout is None:
            timeout = _fetch_timeout()
        done = threading.Event()
        box: list = [None, None]

        def cb(value, err):
            box[0], box[1] = value, err
            done.set()

        self.fetch_async(addr, key, token, cb)
        if not done.wait(timeout=timeout):
            raise PeerFetchError(
                f"peer fetch of d{key[0]}v{key[1]} from {addr} timed out "
                f"after {timeout}s")
        if box[1] is not None:
            raise box[1]
        return box[0]

    def drop(self, addr: Optional[str]) -> None:
        """Close the pooled connection to ``addr`` (peer died/respawned)."""
        if addr is None:
            return
        with self._lock:
            p = self._peers.pop(addr, None)
        if p is not None:
            p.close()

    def close(self) -> None:
        with self._lock:
            self._closed = True
            peers = list(self._peers.values())
            self._peers.clear()
        for p in peers:
            p.close()
