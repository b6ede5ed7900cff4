"""Cluster harnesses: who listens, who spawns agents (DESIGN.md §12).

The scheduler side always *listens*; agents always *dial in* (the
``--connect`` flag), because in real deployments the scheduler's address
is the one thing every node knows.  ``LocalCluster`` packages that for a
single machine: bind an ephemeral localhost port, spawn N agent
subprocesses pointed at it, and hand the listener to the cluster executor
so it can accept the registrations.  With ``spawn=False`` it degrades to
a plain listener for externally-started agents (real multi-node: run
``python -m repro_torch.cluster.agent --connect HOST:PORT --workers N`` on
each node yourself).

Each spawned agent gets this process's torch settings
(``--torch-settings``): its pool workers then run with the scheduler's
deterministic-algorithms and TF32 switches, and make their CUDA context
before they report ready when this process has one.  The agent itself
makes none.
"""
from __future__ import annotations

import json
import os
import queue
import secrets
import socket
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ..core.executors import _torch_settings
from .channel import AgentChannel
from .protocol import recv_msg, send_msg


def _port_pythonpath() -> str:
    """A PYTHONPATH under which agent subprocesses (and their spawned
    pools) can import ``repro_torch`` AND resolve by-reference pickled
    task functions from the caller's modules (e.g. a test module pytest
    put on ``sys.path``) — the full parent search path is propagated,
    deduplicated, order-preserved."""
    import repro_torch
    root = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    parts = [root] + [p for p in sys.path if p]
    return os.pathsep.join(dict.fromkeys(parts))


class LocalCluster:
    """Spawn-and-listen harness for N node agents on this machine.

    Usage::

        with LocalCluster(n_agents=2, workers_per_node=2) as cluster:
            rt = api.runtime_start(backend="cluster", cluster=cluster)
            ...
            api.runtime_stop()   # also tears the agents down

    The runtime's cluster executor calls :meth:`accept_agents` during
    startup and :meth:`respawn` when an agent dies.
    """

    def __init__(self, n_agents: int = 2, workers_per_node: int = 2,
                 host: str = "127.0.0.1", port: int = 0, spawn: bool = True,
                 agent_args: Optional[List[str]] = None):
        self.n_agents = int(n_agents)
        self.workers_per_node = int(workers_per_node)
        self.spawn = spawn
        # per-node object-plane budget, forwarded in the welcome message;
        # the runtime sets this from its memory_budget knob before the
        # executor accepts agents (an agent's own --memory-budget wins)
        self.memory_budget: Optional[int] = None
        # peer-to-peer data plane (DESIGN.md §15): the executor sets these
        # from RJAX_P2P / RJAX_INLINE_MAX before accepting agents;
        # forwarded in the welcome so agents on OTHER hosts (which never
        # saw the scheduler's environment) apply the same result-encoding
        # policy.  An agent's own RJAX_INLINE_MAX wins, like --memory-budget
        self.p2p: bool = True
        self.inline_max: Optional[int] = None
        # telemetry heartbeat cadence (DESIGN.md §17), forwarded in the
        # welcome like the knobs above; an agent's own RJAX_HEARTBEAT_S
        # wins.  None = let agents use their default
        self.heartbeat_s: Optional[float] = None
        # session resumption (DESIGN.md §20): the executor sets the grace
        # window before accepting agents; each welcome carries a fresh
        # session token the agent presents when it re-dials after a
        # transient disconnect.  0/None = resumption disabled.
        self.reconnect_grace_s: Optional[float] = None
        self.session_tokens: Dict[int, str] = {}   # node_id -> current token
        # how accepted/respawned connections become channel objects: the
        # async control plane (DESIGN.md §18) swaps in AsyncAgentChannel
        # bound to its IOLoop; the default is the legacy thread-per-
        # channel reader
        self.channel_factory = AgentChannel
        self._lock = threading.Lock()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(self.n_agents * 2 + 2)
        self.address = "%s:%d" % self._listener.getsockname()[:2]
        self._agent_args = list(agent_args or ())
        self._procs: List[Optional[subprocess.Popen]] = [None] * self.n_agents
        self._closed = False
        # background acceptor (started by the executor once the initial
        # agents are in): routes resume hellos to the executor's handler
        # and parks fresh hellos for respawn() to claim
        self._acceptor: Optional[threading.Thread] = None
        self._fresh_q: "queue.Queue" = queue.Queue()
        if spawn:
            for i in range(self.n_agents):
                self._spawn(i)

    # ------------------------------------------------------------- spawning
    def _spawn(self, i: int) -> None:
        env = dict(os.environ, PYTHONPATH=_port_pythonpath())
        cmd = [sys.executable, "-m", "repro_torch.cluster.agent",
               "--connect", self.address,
               "--workers", str(self.workers_per_node),
               "--node-id", str(i),
               "--torch-settings", json.dumps(_torch_settings()),
               *self._agent_args]
        self._procs[i] = subprocess.Popen(cmd, env=env)

    @property
    def can_respawn(self) -> bool:
        return self.spawn and not self._closed

    def exited(self, i: int, wait_s: float = 0.2) -> bool:
        """Whether agent ``i``'s process has exited (given up to
        ``wait_s`` to finish exiting: its sockets close a moment before
        it can be reaped).  A dead process cannot resume its session, so
        the executor recovers its node at once instead of parking it for
        the grace window.  False for agents this harness did not spawn."""
        proc = self._procs[i] if self.spawn else None
        if proc is None:
            return False
        try:
            proc.wait(timeout=wait_s)
        except subprocess.TimeoutExpired:
            return False
        return True

    # ----------------------------------------------------------- accepting
    def _accept_one(self, timeout: float):
        self._listener.settimeout(timeout)
        try:
            conn, _ = self._listener.accept()
        except socket.timeout:
            raise TimeoutError(
                f"no agent registered with {self.address} within {timeout}s")
        finally:
            self._listener.settimeout(None)
        # the handshake gets the same deadline: a connected-but-silent peer
        # (port scanner, stalled agent) must not hang registration forever
        conn.settimeout(timeout)
        try:
            hello, _ = recv_msg(conn)
        except Exception as err:
            conn.close()
            raise ConnectionError(
                f"agent handshake on {self.address} failed or timed out "
                f"after {timeout}s: {err}") from err
        conn.settimeout(None)
        if hello.get("op") != "hello":
            conn.close()
            raise ConnectionError(f"bad registration message: {hello}")
        return conn, hello

    def _welcome_payload(self, nid: int) -> dict:
        """Mint a fresh session for node ``nid`` and build its welcome.
        A respawned process gets a NEW token — the old session (and any
        reconnect attempt still carrying its token) is dead."""
        tok = secrets.token_hex(8)
        self.session_tokens[nid] = tok
        return {"op": "welcome", "node_id": nid,
                "memory_budget": self.memory_budget,
                "p2p": self.p2p, "inline_max": self.inline_max,
                "heartbeat_s": self.heartbeat_s,
                "session": tok, "epoch": 0,
                "reconnect_grace_s": self.reconnect_grace_s}

    def accept_agents(self, timeout: float = 60.0) -> List[AgentChannel]:
        """Accept ``n_agents`` registrations; returns channels ordered by
        node id.  Defensive against externally-launched agents
        (``spawn=False``): a wrong ``--workers`` is rejected outright (the
        scheduler's slot math depends on it), and an out-of-range or
        duplicate ``--node-id`` is treated as unassigned."""
        raw = [self._accept_one(timeout) for _ in range(self.n_agents)]
        for conn, hello in raw:
            if int(hello.get("workers", -1)) != self.workers_per_node:
                msg = (f"agent pid={hello.get('pid')} registered with "
                       f"--workers {hello.get('workers')} but this cluster "
                       f"requires workers_per_node={self.workers_per_node}")
                for c, _ in raw:
                    c.close()
                raise ConnectionError(msg)
        taken = set()
        for _, h in raw:   # claim valid, non-duplicate explicit node ids
            nid = h.get("node_id")
            if nid is not None and 0 <= nid < self.n_agents and nid not in taken:
                taken.add(nid)
            else:
                h["node_id"] = None
        free = iter(i for i in range(self.n_agents) if i not in taken)
        channels: List[Optional[AgentChannel]] = [None] * self.n_agents
        for conn, hello in raw:
            nid = hello.get("node_id")
            if nid is None:
                nid = next(free)
            send_msg(conn, self._welcome_payload(nid))
            channels[nid] = self.channel_factory(conn, nid, hello)
        return channels

    # -------------------------------------------------- session resumption
    def start_acceptor(self, resume_handler: Callable) -> None:
        """Run a background accept loop (DESIGN.md §20): resume hellos —
        those carrying a ``resume`` token — go to ``resume_handler(conn,
        hello)``; fresh registrations are queued for :meth:`respawn` to
        claim.  Idempotent; the thread exits when the listener closes."""
        if self._acceptor is not None or self._closed:
            return

        def loop():
            while not self._closed:
                try:
                    conn, _ = self._listener.accept()
                except OSError:
                    return   # listener closed: shutdown
                try:
                    conn.settimeout(10.0)
                    hello, _ = recv_msg(conn)
                    conn.settimeout(None)
                    if hello.get("op") != "hello":
                        raise ConnectionError(f"bad hello: {hello}")
                except Exception:
                    conn.close()
                    continue
                if hello.get("resume"):
                    try:
                        resume_handler(conn, hello)
                    except Exception:
                        conn.close()
                else:
                    self._fresh_q.put((conn, hello))

        self._acceptor = threading.Thread(target=loop, daemon=True,
                                          name="cluster-acceptor")
        self._acceptor.start()

    def respawn(self, i: int, timeout: float = 60.0) -> AgentChannel:
        """Replace a dead agent: kill leftovers, spawn a fresh process,
        accept its registration."""
        with self._lock:
            if not self.can_respawn:
                raise RuntimeError("cluster cannot respawn agents")
            proc = self._procs[i]
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait(timeout=5.0)
            self._spawn(i)
            if self._acceptor is not None:
                # the background acceptor owns the listener now; fresh
                # registrations arrive via its queue (respawns are
                # serialized under self._lock, so the next fresh hello is
                # ours)
                try:
                    conn, hello = self._fresh_q.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"no agent registered with {self.address} "
                        f"within {timeout}s")
            else:
                conn, hello = self._accept_one(timeout)
            send_msg(conn, self._welcome_payload(i))
            return self.channel_factory(conn, i, hello)

    # ------------------------------------------------------------ teardown
    def shutdown(self, timeout: float = 5.0) -> None:
        if self._closed:
            return
        self._closed = True
        # grace period: the executor posts "exit" before calling us, so
        # agents are usually mid-teardown — let them finish cleanly (a
        # SIGTERM racing the pool shutdown risks leaving worker processes
        # behind on platforms where the signal wins)
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            if all(p is None or p.poll() is not None for p in self._procs):
                break
            time.sleep(0.05)
        for p in self._procs:
            if p is None or p.poll() is not None:
                continue
            try:
                p.terminate()
            except OSError:
                pass
        for p in self._procs:
            if p is None:
                continue
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=2.0)
        try:
            self._listener.close()
        except OSError:
            pass

    def __enter__(self) -> "LocalCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
