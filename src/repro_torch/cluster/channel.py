"""Scheduler-side connection to one node agent (DESIGN.md §12).

One TCP connection per agent carries every worker slot's traffic,
multiplexed by message id: ``request`` blocks the calling dispatcher
thread until the matching reply arrives, ``request_cb`` registers a
completion *callback* instead (the pipelined dispatch path, DESIGN.md
§14: a slot streams up to depth requests and the reader thread routes
each reply straight into the executor's completion handler), and ``post``
is fire-and-forget (alias/drop/exit control messages).  A single reader
thread per channel routes replies; per-connection FIFO ordering is what
makes the data-plane bookkeeping safe (an ``alias`` posted when a result
is published is always processed by the agent before any later task that
``Ref``-erences the aliased key).

If the agent dies, every pending and future request fails with
:class:`~repro_torch.cluster.protocol.ConnectionClosed`: blocking waiters are
woken with the error, and callback requests are drained (with the error)
on a dedicated thread — never on the thread that noticed the failure,
which may hold the executor's per-agent ordering lock.  The executor maps
either to a retryable ``WorkerCrashedError`` and respawns the agent.
"""
from __future__ import annotations

import socket
import sys
import threading
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import chaos
from .protocol import ConnectionClosed, recv_msg, send_msg


class _Pending:
    __slots__ = ("event", "meta", "frames", "error", "callback")

    def __init__(self, callback: Optional[Callable] = None):
        self.event = threading.Event()
        self.meta: Optional[dict] = None
        self.frames: Optional[List[memoryview]] = None
        self.error: Optional[BaseException] = None
        self.callback = callback


class AgentChannel:
    """A registered, live agent connection."""

    def __init__(self, sock: socket.socket, node_id: int, hello: dict,
                 start_mid: int = 1):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass   # not TCP (e.g. a socketpair in tests)
        self.sock = sock
        self.node_id = node_id
        self.hello = hello            # {"workers": N, "pid": ..., "host": ...,
        #                                "data_port": ...}
        self.closed = False
        # session-resumption interface parity with AsyncAgentChannel
        # (DESIGN.md §20).  The executor only parks channels on the async
        # control plane, but the surface must exist on both so the park
        # logic never AttributeErrors under RJAX_CONTROL_PLANE=threads.
        self.on_lost_pending: Optional[
            Callable[[Dict[int, "_Pending"]], bool]] = None
        self.liveness_killed = False
        # fired exactly once when the connection dies (crash OR close);
        # the executor uses it to start recovery even when no request was
        # in flight — a producer can die holding node-resident results
        # that nobody has asked for yet (DESIGN.md §15)
        self.on_close: Optional[Callable[[], None]] = None
        # agent-initiated push messages (no ``mid``: nothing awaited
        # them) — the telemetry heartbeats ride here (DESIGN.md §17).
        # Runs on the reader thread: handlers must be cheap and non-blocking.
        self.on_push: Optional[Callable[[dict, List[memoryview]], None]] = None
        self._send_lock = threading.Lock()
        self._pending: Dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        self._next_mid = int(start_mid)
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"agent{node_id}-reader")
        self._reader.start()

    @property
    def next_mid(self) -> int:
        """The next mid this channel would assign (mid monotonicity
        across a resumed session, DESIGN.md §20)."""
        with self._pending_lock:
            return self._next_mid

    def adopt_pending(self, pending: Dict[int, _Pending]) -> None:
        """Re-register surviving in-flight slots from a predecessor
        channel (session resumption)."""
        with self._pending_lock:
            for mid, slot in pending.items():
                self._pending.setdefault(mid, slot)

    def data_addr(self) -> Optional[str]:
        """The agent's peer data-plane address (``host:port``): the host
        this connection actually came from (or the ``data_host`` the
        agent explicitly advertised — RJAX_DATA_HOST on multi-homed
        nodes) plus the ``data_port`` from its hello."""
        port = self.hello.get("data_port")
        if not port:
            return None
        host = self.hello.get("data_host")
        if not host:
            try:
                peer = self.sock.getpeername()
                host = peer[0] if isinstance(peer, tuple) else None
            except OSError:
                return None
        if not host:
            return None
        return f"{host}:{port}"

    # ---------------------------------------------------------------- sending
    def _chaos_delay(self) -> None:
        # chaos seam (DESIGN.md §19): scheduler→agent message latency.
        # INJECTOR is None unless RJAX_CHAOS is set — one global load on
        # the hot path.  Sleeps before taking the send lock so injected
        # latency contends like real network latency, not like a stall
        # inside the channel.
        inj = chaos.INJECTOR
        if inj is not None:
            inj.sleep("delay", f"sched-ch{self.node_id}")
            # partition (§20): blackhole this channel's sends for a
            # window without closing the socket.  Blocking is fine here —
            # each legacy channel owns its own sender threads.
            inj.partition_stall(f"sched-ch{self.node_id}")

    def request_async(self, meta: dict, frames: Sequence[Sequence] = ()):
        """Send a request and return a ``wait(timeout=None)`` callable that
        blocks for the reply.  Splitting send from wait lets the executor
        hold its per-agent ordering lock across the send only."""
        slot = _Pending()
        with self._pending_lock:
            if self.closed:
                raise ConnectionClosed(f"agent {self.node_id} is gone")
            mid = self._next_mid
            self._next_mid += 1
            self._pending[mid] = slot
        meta = dict(meta, mid=mid)
        self._chaos_delay()
        try:
            with self._send_lock:
                send_msg(self.sock, meta, frames)
        except ConnectionClosed:
            self._fail_all()
            raise

        def wait(timeout: Optional[float] = None) -> Tuple[dict, List[memoryview]]:
            if not slot.event.wait(timeout=timeout):
                with self._pending_lock:
                    self._pending.pop(mid, None)
                raise TimeoutError(f"agent {self.node_id} did not reply to "
                                   f"{meta.get('op')!r} within {timeout}s")
            if slot.error is not None:
                raise slot.error
            return slot.meta, slot.frames

        return wait

    def request(self, meta: dict, frames: Sequence[Sequence] = (),
                timeout: Optional[float] = None) -> Tuple[dict, List[memoryview]]:
        return self.request_async(meta, frames)(timeout=timeout)

    def request_cb(self, meta: dict, frames: Sequence[Sequence],
                   callback: Callable) -> int:
        """Send a request whose reply is delivered as
        ``callback(meta, frames, error)`` on the channel's reader thread
        (``error`` is None on success); returns the assigned mid.
        Exactly one invocation per accepted request; if the *send
        itself* fails, the callback is NOT invoked — the
        ``ConnectionClosed`` propagates to the caller, which owns that
        task's completion (every other pending request is failed through
        its own callback/waiter)."""
        slot = _Pending(callback=callback)
        with self._pending_lock:
            if self.closed:
                raise ConnectionClosed(f"agent {self.node_id} is gone")
            mid = self._next_mid
            self._next_mid += 1
            self._pending[mid] = slot
        meta = dict(meta, mid=mid)
        self._chaos_delay()
        try:
            with self._send_lock:
                send_msg(self.sock, meta, frames)
        except ConnectionClosed:
            # if the reader noticed the death first it already owns (or
            # drained) every pending slot, ours included — in that case the
            # callback fires with the error and we must NOT also raise, or
            # the task would be completed twice
            with self._pending_lock:
                owned = self._pending.pop(mid, None) is not None
            self._fail_all()
            if owned:
                raise
        return mid

    def post(self, meta: dict, frames: Sequence[Sequence] = ()) -> None:
        """Fire-and-forget control message (no reply expected)."""
        self._chaos_delay()
        try:
            with self._send_lock:
                send_msg(self.sock, meta, frames)
        except ConnectionClosed:
            self._fail_all()
            raise

    # --------------------------------------------------------------- receiving
    def _read_loop(self) -> None:
        try:
            while True:
                meta, frames = recv_msg(self.sock)
                mid = meta.get("mid")
                if mid is None:
                    # unsolicited agent→scheduler push (heartbeats)
                    cb = self.on_push
                    if cb is not None:
                        try:
                            cb(meta, frames)
                        except BaseException:
                            traceback.print_exc(file=sys.stderr)
                    continue
                with self._pending_lock:
                    slot = self._pending.pop(mid, None)
                if slot is None:
                    continue
                if slot.callback is not None:
                    # completion runs here, outside the pending lock; a
                    # raising completion is an executor bug — surfacing it
                    # must not take the whole channel down
                    try:
                        slot.callback(meta, frames, None)
                    except BaseException:
                        traceback.print_exc(file=sys.stderr)
                else:
                    slot.meta, slot.frames = meta, frames
                    slot.event.set()
        except BaseException as err:  # noqa: BLE001 — a reader that dies
            # silently (e.g. an unpicklable reply meta) would leave every
            # dispatcher on this agent blocked forever; ANY exit must fail
            # the pending requests
            self._fail_all(err)

    def _fail_all(self, err: Optional[BaseException] = None) -> None:
        with self._pending_lock:
            self.closed = True
            pending = dict(self._pending)
            self._pending.clear()
            on_close, self.on_close = self.on_close, None
        if on_close is not None:
            # on its own thread: recovery (agent respawn, lineage
            # re-execution) takes executor/store/graph locks that the
            # thread noticing the failure may already hold
            threading.Thread(target=on_close, daemon=True,
                             name=f"agent{self.node_id}-onclose").start()
        if not pending:
            return
        # session resumption (§20): the executor may adopt the in-flight
        # map instead of having every slot errored (see AsyncAgentChannel)
        hook = self.on_lost_pending
        if hook is not None:
            try:
                if hook(pending):
                    return
            except BaseException:
                traceback.print_exc(file=sys.stderr)
        err = err if err is not None else ConnectionClosed(
            f"agent {self.node_id} connection lost", mid_message=True)
        cb_slots = []
        for slot in pending.values():
            if slot.callback is not None:
                cb_slots.append(slot)
            else:
                slot.error = err
                slot.event.set()
        if cb_slots:
            # drain callbacks on their own thread: _fail_all may run on a
            # sender thread that holds the executor's per-agent ordering
            # lock, which the failure handlers (agent restart) also take
            def drain():
                for slot in cb_slots:
                    try:
                        slot.callback(None, None, err)
                    except BaseException:
                        traceback.print_exc(file=sys.stderr)

            threading.Thread(target=drain, daemon=True,
                             name=f"agent{self.node_id}-fail").start()

    # ----------------------------------------------------------------- closing
    def close(self) -> None:
        self._fail_all(ConnectionClosed(f"agent {self.node_id} channel closed"))
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
