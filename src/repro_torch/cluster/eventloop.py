"""Single-threaded asyncio control plane (DESIGN.md §18).

The scheduler used to spend one reader **thread** per agent channel plus
one dispatcher thread per worker slot — O(agents + slots) threads whose
wakeup latency bounded dispatch at scale.  This module replaces the
per-channel thread with one :class:`IOLoop` (a single daemon thread
running an asyncio event loop) that owns a reader/writer **coroutine
pair** per agent socket:

* the *writer* drains a per-channel send queue, coalescing consecutive
  small messages (≤ ``RJAX_WIRE_COALESCE`` each) into one socket write —
  the batched-stream idiom — and falling back to per-part zero-copy
  ``sock_sendall`` for large framed payloads;
* the *reader* parses the §12 wire format with exact-size
  ``sock_recv_into`` reads (frames land in freshly allocated buffers,
  no intermediate copies) and routes completions **inline on the loop**:
  mid-less pushes to ``on_push`` (§17 heartbeats), callback slots
  directly, blocking requests via an event bridge.

Protocol invariants the loop *enforces* (formerly emergent from thread
structure):

* **wire FIFO / Put-before-Ref (§12)** — each channel has exactly one
  send queue drained by exactly one writer coroutine, so messages leave
  in enqueue order no matter how many threads enqueue; the executor's
  per-agent order lock pins residency marks to enqueue order, and the
  queue does the rest.
* **credit accounting (§14)** — completions release credits on the loop
  and re-enter the dispatch pump inline, so a freed credit is reused
  without a thread wakeup.
* **exactly-once completion (§14/§15)** — a registered mid resolves
  exactly once: with the reply, or with ``ConnectionClosed`` when the
  channel fails; callback draining on failure happens OFF the loop (a
  one-shot thread) so restart work can never stall the other channels.

``AsyncAgentChannel`` is interface-compatible with
``channel.AgentChannel`` (the legacy per-thread channel, kept for
``RJAX_CONTROL_PLANE=threads``): same constructor shape via
``LocalCluster.channel_factory``, same ``request`` / ``request_async`` /
``request_cb`` / ``post`` / ``on_push`` / ``on_close`` surface.
"""
from __future__ import annotations

import asyncio
import pickle
import socket
import threading
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import chaos, protocol
from .protocol import ConnectionClosed

__all__ = ["IOLoop", "AsyncAgentChannel"]


class IOLoop:
    """An asyncio event loop confined to one daemon thread.

    The loop thread is the *only* place channel coroutines run;
    schedule work onto it from any thread with :meth:`call_soon`.
    """

    def __init__(self, name: str = "rjax-io"):
        self._loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()
        self._started.wait()

    def _run(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        try:
            self._loop.run_forever()
        finally:
            pending = asyncio.all_tasks(self._loop)
            for task in pending:
                task.cancel()
            if pending:
                try:
                    self._loop.run_until_complete(asyncio.gather(
                        *pending, return_exceptions=True))
                except BaseException:
                    pass
            try:
                self._loop.close()
            except BaseException:
                pass

    @property
    def loop(self) -> asyncio.AbstractEventLoop:
        return self._loop

    def in_loop(self) -> bool:
        return threading.current_thread() is self._thread

    def call_soon(self, cb: Callable, *args: Any) -> bool:
        """Run ``cb(*args)`` on the loop thread; False if the loop is
        already gone (shutdown races are the caller's no-op)."""
        if self._closed:
            return False
        if self.in_loop():
            cb(*args)
            return True
        try:
            self._loop.call_soon_threadsafe(cb, *args)
            return True
        except RuntimeError:
            return False

    def stop(self, timeout: float = 2.0) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass
        if not self.in_loop():
            self._thread.join(timeout)


class _Slot:
    """One in-flight request: either a blocking waiter (event bridge)
    or a completion callback routed inline on the loop."""
    __slots__ = ("event", "meta", "frames", "error", "callback")

    def __init__(self, callback=None):
        self.event = None if callback is not None else threading.Event()
        self.meta = None
        self.frames = None
        self.error: Optional[BaseException] = None
        self.callback = callback


class AsyncAgentChannel:
    """One agent connection, serviced by coroutines on a shared IOLoop.

    Thread-free per channel: senders encode on their own thread and
    enqueue; the loop's writer coroutine owns the socket's write side,
    the reader coroutine owns the read side and routes completions.
    """

    def __init__(self, sock: socket.socket, node_id: int, hello: dict,
                 io: IOLoop, start_mid: int = 1):
        self.sock = sock
        self.node_id = node_id
        self.hello = hello
        self.io = io
        self.closed = False
        self.on_close: Optional[Callable[[], None]] = None
        self.on_push: Optional[Callable[[dict, list], None]] = None
        # session resumption (DESIGN.md §20): when the channel dies, the
        # executor may take ownership of the in-flight mid->slot map via
        # this hook (returning True) instead of having every slot errored
        # — the slots are re-adopted into the resumed channel.  A DEAD
        # liveness verdict sets ``liveness_killed`` before close() so the
        # park path can tell a kill from a transient disconnect.
        self.on_lost_pending: Optional[
            Callable[[Dict[int, _Slot]], bool]] = None
        self.liveness_killed = False
        try:
            self._peer = sock.getpeername()
        except OSError:
            self._peer = None
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass   # socketpair harnesses have no TCP options
        sock.setblocking(False)
        # send side: encoded messages [(parts, total_bytes)], one queue,
        # one writer — FIFO by construction
        self._send_queue: deque = deque()
        self._send_lock = threading.Lock()
        self._wake = asyncio.Event()
        # request side
        self._pending: Dict[int, _Slot] = {}
        self._pending_lock = threading.Lock()
        self._next_mid = int(start_mid)
        self._failed = False
        # batching counters (asserted by tests: msgs_sent can exceed
        # writes when the coalescer is doing its job)
        self.msgs_sent = 0
        self.writes = 0
        self._tasks: List[asyncio.Task] = []
        io.call_soon(self._start_io)

    # ------------------------------------------------------------ loop side
    def _start_io(self) -> None:
        if self.closed:
            return
        loop = self.io.loop
        self._tasks = [loop.create_task(self._read_loop()),
                       loop.create_task(self._write_loop())]

    async def _write_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                await self._wake.wait()
                self._wake.clear()
                # chaos seam (§19/§20): a network partition blackholes
                # this channel's sends for a window WITHOUT closing the
                # socket.  awaited, never slept — other channels on the
                # shared loop keep flowing (per-scope windows).
                inj = chaos.INJECTOR
                if inj is not None:
                    stall = inj.partition_window(
                        f"sched-aioch{self.node_id}")
                    if stall > 0.0:
                        await asyncio.sleep(stall)
                while True:
                    # coalesce: consecutive small messages become ONE
                    # socket write; a large framed message flushes the
                    # batch and goes out part-by-part (zero-copy)
                    coalesce = max(1, protocol.WIRE_COALESCE_MAX)
                    flush_cap = max(coalesce, min(16 * coalesce, 1 << 20))
                    batch = bytearray()
                    big = None
                    with self._send_lock:
                        if not self._send_queue:
                            break
                        while self._send_queue:
                            parts, total = self._send_queue[0]
                            if total <= coalesce \
                                    and len(batch) + total <= flush_cap:
                                self._send_queue.popleft()
                                for p in parts:
                                    batch += p
                                self.msgs_sent += 1
                            elif not batch:
                                big = self._send_queue.popleft()
                                self.msgs_sent += 1
                                break
                            else:
                                break
                    if batch:
                        self.writes += 1
                        await loop.sock_sendall(self.sock, batch)
                    if big is not None:
                        self.writes += 1
                        for p in big[0]:
                            await loop.sock_sendall(self.sock, p)
        except asyncio.CancelledError:
            raise
        except (OSError, ConnectionClosed) as err:
            self._fail_all(ConnectionClosed(
                f"agent {self.node_id} connection lost: {err}",
                mid_message=True))
        except BaseException as err:   # pragma: no cover - defensive
            self._fail_all(err)

    async def _recv_exactly(self, loop, n: int) -> memoryview:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            k = await loop.sock_recv_into(self.sock, view[got:])
            if k == 0:
                raise ConnectionClosed(
                    f"agent {self.node_id} connection closed mid-message",
                    mid_message=got > 0)
            got += k
        return view

    async def _read_loop(self) -> None:
        loop = asyncio.get_running_loop()
        head_size = protocol._HEAD.size
        try:
            while True:
                head = await self._recv_exactly(loop, head_size)
                magic, n = protocol._HEAD.unpack(bytes(head))
                if magic != protocol.MAGIC:
                    raise ConnectionClosed(
                        f"bad magic {magic!r} from agent {self.node_id}",
                        mid_message=True)
                lens = await self._recv_exactly(loop, 8 * n)
                lengths = [protocol._U64.unpack_from(lens, 8 * i)[0]
                           for i in range(n)]
                meta = pickle.loads(await self._recv_exactly(
                    loop, lengths[0]))
                frames = [await self._recv_exactly(loop, ln)
                          for ln in lengths[1:]]
                if protocol.WIRE_CHECKSUM:
                    frames = [protocol.verify_frame(f) for f in frames]
                self._dispatch(meta, frames)
        except asyncio.CancelledError:
            raise
        except (OSError, EOFError, ConnectionClosed,
                pickle.UnpicklingError) as err:
            self._fail_all(ConnectionClosed(
                f"agent {self.node_id} connection lost: {err}",
                mid_message=True))
        except BaseException as err:   # pragma: no cover - defensive
            self._fail_all(err)

    def _dispatch(self, meta: dict, frames: list) -> None:
        """Completion routing, inline on the loop (DESIGN.md §18)."""
        mid = meta.get("mid")
        if mid is None:
            cb = self.on_push
            if cb is not None:
                try:
                    cb(meta, frames)
                except BaseException:
                    traceback.print_exc()
            return
        with self._pending_lock:
            slot = self._pending.pop(mid, None)
        if slot is None:
            return   # timed-out waiter already gave up on this mid
        if slot.callback is not None:
            try:
                slot.callback(meta, frames, None)
            except BaseException:
                traceback.print_exc()
        else:
            slot.meta, slot.frames = meta, frames
            slot.event.set()

    # ---------------------------------------------------------- caller side
    @property
    def next_mid(self) -> int:
        """The next mid this channel would assign — a resumed channel is
        constructed with ``start_mid=next_mid`` of its predecessor so the
        mid sequence stays monotonic across the session (§20)."""
        with self._pending_lock:
            return self._next_mid

    def adopt_pending(self, pending: Dict[int, _Slot]) -> None:
        """Re-register surviving in-flight slots from a predecessor
        channel (session resumption): their replies will arrive on THIS
        connection carrying the original mids."""
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
            host = self._peer[0] if self._peer else None
        if not host:
            return None
        return f"{host}:{port}"

    @staticmethod
    def _encode(meta: dict, frames) -> Tuple[list, int]:
        """Wire-encode on the *caller's* thread (pickling off the loop);
        mirrors ``protocol.send_msg``'s framing exactly, including the
        optional CRC32 trailers (RJAX_WIRE_CHECKSUM).  The ``bitflip``
        chaos seam intentionally lives only in ``protocol.send_msg`` —
        agent replies and the p2p plane — so injected corruption always
        exercises a *receive*-side detection path."""
        checksum = protocol.WIRE_CHECKSUM
        meta_blob = pickle.dumps(meta, protocol=5)
        lengths = [len(meta_blob)]
        parts: list = [b"", meta_blob]   # placeholder for the header
        for f in frames or ():
            if not isinstance(f, (list, tuple)):
                f = (f,)
            ln = sum(len(p) for p in f)
            parts.extend(f)
            if checksum:
                parts.append(protocol._CRC.pack(protocol.frame_crc(f)))
                ln += protocol._CRC.size
            lengths.append(ln)
        header = protocol._HEAD.pack(protocol.MAGIC, len(lengths)) \
            + b"".join(protocol._U64.pack(ln) for ln in lengths)
        parts[0] = header
        return parts, len(header) + sum(lengths)

    def _enqueue(self, meta: dict, frames=()) -> None:
        # chaos seam (DESIGN.md §19): scheduler→agent message latency on
        # the async plane.  One global load when chaos is off.  Note the
        # pump runs _enqueue on the loop thread, so an injected delay
        # stalls the whole control plane for its duration — exactly the
        # pathological-scheduler-stall failure mode worth exercising.
        inj = chaos.INJECTOR
        if inj is not None:
            inj.sleep("delay", f"sched-aioch{self.node_id}")
        parts, total = self._encode(meta, frames)
        with self._send_lock:
            if self.closed:
                raise ConnectionClosed(
                    f"agent {self.node_id} channel closed")
            self._send_queue.append((parts, total))
        self.io.call_soon(self._wake.set)

    def post(self, meta: dict, frames=()) -> None:
        """Fire-and-forget (no mid, no reply expected)."""
        self._enqueue(meta, frames)

    def request_async(self, meta: dict, frames=()):
        """Send now, collect later: returns ``wait(timeout)``."""
        slot = _Slot()
        with self._pending_lock:
            if self.closed:
                raise ConnectionClosed(
                    f"agent {self.node_id} channel closed")
            mid = self._next_mid
            self._next_mid += 1
            self._pending[mid] = slot
        meta = dict(meta, mid=mid)
        op = meta.get("op")
        try:
            self._enqueue(meta, frames)
        except ConnectionClosed:
            with self._pending_lock:
                self._pending.pop(mid, None)
            self._fail_all()
            raise

        def wait(timeout: Optional[float] = None):
            assert not self.io.in_loop(), \
                "blocking request on the IO loop thread"
            if not slot.event.wait(timeout):
                with self._pending_lock:
                    self._pending.pop(mid, None)
                raise TimeoutError(
                    f"agent {self.node_id} did not reply to {op!r} "
                    f"within {timeout}s")
            if slot.error is not None:
                raise slot.error
            return slot.meta, slot.frames

        return wait

    def request(self, meta: dict, frames=(), timeout: Optional[float] = None):
        return self.request_async(meta, frames)(timeout)

    def request_cb(self, meta: dict, frames,
                   callback: Callable[[Optional[dict], Optional[list],
                                       Optional[BaseException]], None]) -> int:
        """Send now, deliver the reply to ``callback(meta, frames, err)``
        exactly once — with the reply (on the loop) or with the channel
        failure (off the loop).  Returns the assigned mid (the session
        resumption ledger keys re-submittable requests by it).  Raises
        only if the send itself failed while this call still owned the
        mid (the caller then handles the task; the callback will never
        fire for it)."""
        slot = _Slot(callback=callback)
        with self._pending_lock:
            if self.closed:
                raise ConnectionClosed(
                    f"agent {self.node_id} channel closed")
            mid = self._next_mid
            self._next_mid += 1
            self._pending[mid] = slot
        meta = dict(meta, mid=mid)
        try:
            self._enqueue(meta, frames)
        except ConnectionClosed:
            with self._pending_lock:
                owned = self._pending.pop(mid, None) is not None
            self._fail_all()
            if owned:
                raise
        return mid

    # ------------------------------------------------------------- teardown
    def _cancel_tasks(self) -> None:
        for t in self._tasks:
            t.cancel()

    def _fail_all(self, err: Optional[BaseException] = None) -> None:
        """Idempotent teardown: every registered mid resolves with the
        error, ``on_close`` fires once.  Callback draining and on_close
        run on a one-shot thread so channel failure can never block the
        loop (restart work happens there)."""
        with self._pending_lock:
            if self._failed:
                return
            self._failed = True
            self.closed = True
            pending = dict(self._pending)
            self._pending.clear()
            on_close, self.on_close = self.on_close, None
        if err is None:
            err = ConnectionClosed(
                f"agent {self.node_id} connection lost", mid_message=True)
        self.io.call_soon(self._cancel_tasks)
        # session resumption (§20): give the executor first refusal on
        # the in-flight map — True means it parked the slots for adoption
        # by a resumed channel, so they are NOT errored here.  on_close
        # still fires (it drives the park/grace bookkeeping).
        adopted = False
        hook = self.on_lost_pending
        if pending and hook is not None:
            try:
                adopted = bool(hook(pending))
            except BaseException:
                traceback.print_exc()
        cbs = []
        if not adopted:
            for slot in pending.values():
                if slot.callback is None:
                    slot.error = err
                    slot.event.set()
                else:
                    cbs.append(slot)
        if cbs or on_close is not None:
            def drain():
                if on_close is not None:
                    try:
                        on_close()
                    except BaseException:
                        traceback.print_exc()
                for slot in cbs:
                    try:
                        slot.callback(None, None, err)
                    except BaseException:
                        traceback.print_exc()
            threading.Thread(target=drain, daemon=True,
                             name=f"agent{self.node_id}-fail").start()

    def _close_sock(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass

    def close(self) -> None:
        self._fail_all(ConnectionClosed(
            f"agent {self.node_id} channel closed"))
        # close the fd from the loop, after the coroutines are cancelled,
        # so a pending sock_recv_into never sees a recycled fd; fall back
        # to closing inline when the loop is already gone
        if not self.io.call_soon(self._close_sock):
            self._close_sock()
