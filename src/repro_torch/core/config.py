"""Unified runtime configuration (DESIGN.md §18).

One dataclass — :class:`RuntimeConfig` — declares every knob the runtime
understands: the ``runtime_start(...)`` keyword arguments *and* the
``RJAX_*`` environment variables that used to be scattered across the
modules that read them.  Each field carries its env-var name, built-in
default, cast, and doc string, so the README knob table is **generated**
from this file (``python -m repro.core.config``) rather than
hand-maintained, and ``tests/test_config.py`` asserts no module grows an
undeclared knob.

One precedence rule, applied everywhere (including the agent CLI)::

    explicit kwarg / CLI flag  >  env var  >  welcome-handshake value
                               >  built-in default

Evaluated **per process**: an agent's local env var outranks the value
the scheduler's welcome message carries (the welcome is how the
scheduler's *own* resolution propagates to agents that set nothing).
``resolve()`` is the single implementation of that rule; every consumer
(``Runtime``, ``NodeAgent``, the agent argparser) routes through it.

A ``RuntimeConfig`` field that is ``None`` means *unset* — resolution
falls through to the environment and the built-in default.  This is what
lets ``runtime_start(pipeline_depth=8)``, ``RJAX_PIPELINE_DEPTH=8`` and
the welcome handshake all land in the same place without the call sites
knowing which one fired.
"""
from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Dict, Optional

__all__ = [
    "RuntimeConfig", "resolve", "knob_table", "declared_env_knobs",
    "parse_bool", "add_agent_cli_args",
]

_UNSET = None   # field value meaning "fall through to env/welcome/default"


# --------------------------------------------------------------------- casts
def parse_bool(value: Any) -> bool:
    """``RJAX_P2P=0`` / ``off`` / ``false`` / ``no`` are all false."""
    if isinstance(value, bool):
        return value
    if value is None:
        return False
    return str(value).strip().lower() not in ("0", "false", "off", "no", "")


def _parse_port(value: Any) -> Optional[int]:
    if value is None or value == "":
        return None
    return int(value)


def _parse_budget(value: Any):
    from .memory import parse_bytes
    return parse_bytes(value)


# --------------------------------------------------------------------- knobs
def knob(*, env: Optional[str] = None, default: Any = None,
         cast: Callable[[Any], Any] = None, doc: str = "",
         scope: str = "runtime", cli: Optional[str] = None):
    """Declare one configuration field.

    ``scope`` records where the knob is consumed, for the generated docs:
    ``runtime`` (a ``runtime_start`` kwarg, possibly env-backed), ``env``
    (read from the environment by a leaf module — still declared here so
    the orphan-knob test can see it), ``agent`` (also mirrored onto the
    ``repro.cluster.agent`` CLI), ``object`` (a live Python object that
    never crosses env/CLI, e.g. ``cluster``).
    """
    return field(default=_UNSET, metadata={
        "env": env, "default": default, "cast": cast, "doc": doc,
        "scope": scope, "cli": cli,
    })


def resolve(explicit: Any, env: Optional[str], welcome: Any = None,
            default: Any = None, cast: Callable[[Any], Any] = None) -> Any:
    """THE precedence rule: explicit > env var > welcome > default."""
    if explicit is not None:
        value = explicit
    elif env is not None and os.environ.get(env) not in (None, ""):
        value = os.environ[env]
    elif welcome is not None:
        value = welcome
    else:
        value = default
    if value is not None and cast is not None:
        value = cast(value)
    return value


@dataclass
class RuntimeConfig:
    """Every runtime knob in one place.  All fields default to *unset*
    (``None``); construct with only what you mean to pin::

        with runtime_start(config=RuntimeConfig(backend="cluster",
                                                n_agents=4)) as rt:
            ...
    """

    # -- core topology ----------------------------------------------------
    n_workers: Optional[int] = knob(
        default=4, cast=int,
        doc="Worker slots the runtime dispatches to (cluster backend: "
            "derived as n_agents x workers_per_node).")
    workers_per_node: Optional[int] = knob(
        default=None, cast=int,
        doc="Worker processes per node agent (cluster backend; default 2).")
    n_agents: Optional[int] = knob(
        default=None, cast=int,
        doc="Node agents a LocalCluster spawns (cluster backend; default 2).")
    backend: Optional[str] = knob(
        default="thread",
        doc="Executor backend: thread | process | cluster.")
    cluster: Optional[Any] = knob(
        default=None, scope="object",
        doc="Pre-built LocalCluster to adopt instead of spawning one.")
    policy: Optional[str] = knob(
        default="fifo",
        doc="Scheduling policy: fifo | lifo | worksteal | locality.")

    # -- retry / speculation ----------------------------------------------
    max_retries: Optional[int] = knob(
        default=0, cast=int,
        doc="Automatic re-submissions per failed task.")
    retry_backoff_s: Optional[float] = knob(
        env="RJAX_RETRY_BACKOFF_S", default=0.0, cast=float,
        doc="Base re-queue delay after a failed attempt; grows "
            "exponentially (x2 per attempt, capped at 30 s) with up to "
            "25% jitter.  0 = immediate (lost-input pacing still applies).")
    speculation: Optional[bool] = knob(
        default=False, cast=parse_bool,
        doc="Duplicate straggler tasks (first completion wins).")
    speculation_factor: Optional[float] = knob(
        default=3.0, cast=float,
        doc="A task is a straggler past factor x its name's mean duration.")

    # -- fault tolerance (DESIGN.md §19) ----------------------------------
    liveness: Optional[bool] = knob(
        env="RJAX_LIVENESS", default=True, cast=parse_bool,
        doc="Scheduler-side failure detector over heartbeat ages (cluster "
            "backend): a node silent past the suspicion window has its "
            "channel closed, driving the normal respawn/lineage recovery.")
    suspicion_s: Optional[float] = knob(
        env="RJAX_SUSPICION_S", default=5.0, cast=float,
        doc="Heartbeat age after which a node is suspect; dead (and "
            "recovered) at 2x this, never sooner than 3 beat periods.")
    deadline_s: Optional[float] = knob(
        env="RJAX_DEADLINE_S", default=None, cast=float,
        doc="Default per-task deadline: a task body running longer has "
            "its worker killed and fails retryable.  Per-call "
            "submit(deadline_s=) overrides; unset = no deadline.")
    resolve_timeout_s: Optional[float] = knob(
        env="RJAX_RESOLVE_TIMEOUT_S", default=30.0, cast=float,
        doc="Seconds a dispatch may wait for an input datum to resolve "
            "(spill fault-back, §15 lineage rebuild) before failing "
            "retryable.")
    reconnect_grace_s: Optional[float] = knob(
        env="RJAX_RECONNECT_GRACE_S", default=5.0, cast=float,
        doc="Seconds a disconnected agent is parked awaiting session "
            "resumption (DESIGN.md §20) before the scheduler falls back "
            "to respawn + lineage recovery.  0 disables resumption "
            "(every disconnect is treated as death, the pre-§20 "
            "behaviour).  Async control plane only.")
    replication: Optional[int] = knob(
        env="RJAX_REPLICATION", default=0, cast=int,
        doc="Replicas kept of expensive node-resident intermediates "
            "(DESIGN.md §20): results whose producer duration crosses "
            "the TaskGraph-derived threshold are pushed to k buddy "
            "nodes over the p2p plane, so node death recovers by "
            "refetch instead of lineage replay.  0 = off.")
    chaos: Optional[str] = knob(
        env="RJAX_CHAOS", default=None, scope="env",
        doc="Deterministic fault injection, '<seed>:<fault>[=arg][@rate],"
            "...' (repro.cluster.chaos); faults: delay, drop, stall, "
            "freeze, hang, fetch-slow, partition, bitflip.  Unset = "
            "zero-overhead no-op.")

    # -- memory -----------------------------------------------------------
    memory_budget: Optional[Any] = knob(
        env="RJAX_MEMORY_BUDGET", default=None, cast=_parse_budget,
        scope="agent", cli="--memory-budget",
        doc="Per-domain object-plane budget (e.g. 256M, 2G); unset = "
            "unbounded.  Welcome-propagated to agents that set nothing.")
    spill_dir: Optional[str] = knob(
        default=None,
        doc="Directory for spill files (default: the system tmpdir).")
    spill_min_bytes: Optional[int] = knob(
        env="RJAX_SPILL_MIN_BYTES", default=4096, cast=int, scope="env",
        doc="Smallest ndarray the memory governor will spill.")
    shm_min_bytes: Optional[int] = knob(
        env="RJAX_SHM_MIN_BYTES", default=16384, cast=int, scope="env",
        doc="Smallest ndarray shipped via shared-memory segments "
            "(process pool); smaller ones ride the pipe.")

    # -- dispatch pipeline ------------------------------------------------
    pipeline_depth: Optional[int] = knob(
        env="RJAX_PIPELINE_DEPTH", default=4, cast=int,
        doc="In-flight task credits per worker slot (DESIGN.md §14); "
            "1 = stop-and-wait.")
    control_plane: Optional[str] = knob(
        env="RJAX_CONTROL_PLANE", default="async",
        doc="Cluster scheduler comm layer: async (single event-loop "
            "thread, DESIGN.md §18) | threads (legacy reader thread per "
            "agent + dispatcher thread per slot).")
    lost_input_retries: Optional[int] = knob(
        env="RJAX_LOST_INPUT_RETRIES", default=3, cast=int, scope="env",
        doc="Extra retry budget for tasks whose inputs died with a node.")
    fn_cache_max: Optional[int] = knob(
        env="RJAX_FN_CACHE_MAX", default=512, cast=int, scope="env",
        doc="Deserialized-function cache entries per worker process.")
    graph_retain: Optional[int] = knob(
        env="RJAX_GRAPH_RETAIN", default=0, cast=int, scope="env",
        doc="Completed-task records kept for lineage (0 = automatic).")
    mp_context: Optional[str] = knob(
        env="RJAX_MP_CONTEXT", default="spawn", scope="agent",
        cli="--mp-context",
        doc="multiprocessing start method for worker pools (spawn | fork; "
            "fork raises once CUDA is initialised).")

    # -- cluster wire / data plane ----------------------------------------
    inline_max: Optional[int] = knob(
        env="RJAX_INLINE_MAX", default=8192, cast=int,
        scope="agent", cli="--inline-max",
        doc="Results under this many bytes ride the reply inline; larger "
            "ones stay node-resident behind a RemoteRef (DESIGN.md §15).  "
            "Welcome-propagated.")
    p2p: Optional[bool] = knob(
        env="RJAX_P2P", default=True, cast=parse_bool,
        doc="Peer-to-peer data plane; 0 restores the all-relay star "
            "topology for A/B runs.  Welcome-propagated.")
    wire_coalesce: Optional[int] = knob(
        env="RJAX_WIRE_COALESCE", default=65536, cast=int, scope="env",
        doc="Messages up to this size are coalesced into one socket write "
            "(the async control plane batches consecutive small messages "
            "up to ~16x this per flush).")
    data_host: Optional[str] = knob(
        env="RJAX_DATA_HOST", default=None, scope="env",
        doc="Interface the agent data server binds/advertises "
            "(multi-homed deployments).")
    peer_fetch_timeout: Optional[float] = knob(
        env="RJAX_PEER_FETCH_TIMEOUT", default=60.0, cast=float, scope="env",
        doc="Seconds a peer pull may take before it fails as retryable.")
    wire_checksum: Optional[bool] = knob(
        env="RJAX_WIRE_CHECKSUM", default=False, cast=parse_bool,
        scope="env",
        doc="CRC32 trailer on every out-of-band array frame (control "
            "and data plane): a corrupted frame surfaces as a retryable "
            "transfer error instead of silent data corruption.  Off by "
            "default (overhead gated in bench_gate.py).")

    # -- telemetry ---------------------------------------------------------
    tracing: Optional[bool] = knob(
        default=True, cast=parse_bool,
        doc="Task-lifecycle tracer (Paraver/Chrome exports).")
    telemetry: Optional[bool] = knob(
        default=None, cast=parse_bool,
        doc="Live telemetry plane (DESIGN.md §17); default follows "
            "tracing.")
    heartbeat_s: Optional[float] = knob(
        env="RJAX_HEARTBEAT_S", default=1.0, cast=float,
        scope="agent", cli="--heartbeat-s",
        doc="Agent heartbeat cadence in seconds (0 disables).  "
            "Welcome-propagated.")
    telemetry_ring: Optional[int] = knob(
        env="RJAX_TELEMETRY_RING", default=4096, cast=int, scope="env",
        doc="Task-lifecycle ring capacity (events kept for /api/tasks).")
    dashboard_port: Optional[int] = knob(
        env="RJAX_DASHBOARD", default=None, cast=_parse_port,
        doc="Serve the live dashboard on this port (0 = ephemeral); "
            "unset = off.")

    # ------------------------------------------------------------------ api
    def resolved(self, name: str, welcome: Any = None) -> Any:
        """Resolve one field through the precedence rule."""
        f = _field_map()[name]
        return resolve(getattr(self, name), f.metadata["env"], welcome,
                       f.metadata["default"], f.metadata["cast"])

    def merged(self, **overrides: Any) -> "RuntimeConfig":
        """Copy with explicit (non-None) overrides applied on top —
        the ``runtime_start(config=..., pipeline_depth=8)`` shim."""
        known = _field_map()
        unknown = [k for k in overrides if k not in known]
        if unknown:
            raise TypeError(
                f"runtime_start() got unexpected keyword argument(s) "
                f"{', '.join(sorted(unknown))!s}; known knobs: "
                f"{', '.join(sorted(known))}")
        kept = {k: v for k, v in overrides.items() if v is not None}
        return dataclasses.replace(self, **kept)

    def runtime_kwargs(self) -> Dict[str, Any]:
        """The kwargs ``Runtime.__init__`` consumes, unset fields
        omitted (Runtime's own env-aware defaults then apply — same
        precedence, evaluated at the leaf)."""
        out = {}
        for name in ("n_workers", "workers_per_node", "policy", "tracing",
                     "backend", "cluster", "n_agents", "memory_budget",
                     "spill_dir", "pipeline_depth", "telemetry",
                     "dashboard_port", "control_plane", "inline_max",
                     "heartbeat_s", "p2p", "liveness", "suspicion_s",
                     "deadline_s", "resolve_timeout_s",
                     "reconnect_grace_s", "replication", "mp_context"):
            v = getattr(self, name)
            if v is not None:
                out[name] = v
        return out


def _field_map() -> Dict[str, dataclasses.Field]:
    return {f.name: f for f in fields(RuntimeConfig)}


def declared_env_knobs() -> Dict[str, str]:
    """``{env var name: field name}`` for every env-backed knob — the
    contract ``tests/test_config.py`` checks ``src/`` against."""
    return {f.metadata["env"]: f.name for f in fields(RuntimeConfig)
            if f.metadata.get("env")}


# ----------------------------------------------------------------- knob table
def knob_table() -> str:
    """The README's knob table, generated.  Markdown; stable ordering
    (declaration order) so the README-sync test is byte-exact."""
    lines = [
        "| knob | env var | default | what it does |",
        "|---|---|---|---|",
    ]
    for f in fields(RuntimeConfig):
        m = f.metadata
        if m["scope"] == "object":
            continue
        if m["scope"] == "env" and m["env"] is None:
            continue
        name = f"`{f.name}`" if m["scope"] != "env" else "—"
        env = f"`{m['env']}`" if m["env"] else "—"
        default = m["default"]
        if default is None:
            default = "unset"
        elif isinstance(default, bool):
            default = "on" if default else "off"
        doc = " ".join(str(m["doc"]).split())
        lines.append(f"| {name} | {env} | {default} | {doc} |")
    return "\n".join(lines)


# ------------------------------------------------------------------ agent CLI
def add_agent_cli_args(parser) -> None:
    """Mirror the agent-scoped knobs onto ``repro.cluster.agent``'s
    argparser, docs included — one source of truth for flag/env/welcome
    precedence (the flag is the *explicit* tier of ``resolve``)."""
    for f in fields(RuntimeConfig):
        m = f.metadata
        if not m.get("cli"):
            continue
        env_note = f" (env {m['env']}; welcome-propagated)" if m["env"] else ""
        parser.add_argument(
            m["cli"], dest=f.name, default=None, metavar=f.name.upper(),
            help=" ".join(str(m["doc"]).split()) + env_note)


def _main() -> int:
    print(knob_table())
    return 0


if __name__ == "__main__":   # pragma: no cover - exercised via README sync
    raise SystemExit(_main())
