"""repro_torch.cluster — real multi-node execution over TCP (DESIGN.md §12),
the port's copy.

The package has six pieces:

* :mod:`repro_torch.cluster.protocol` — the length-prefixed wire format:
  message metadata rides pickle, ndarrays ride separate raw-codec frames
  (the ``serialization.py`` header format, byte for byte the JAX
  package's) and tensors ride tensor frames (host bytes with their dtype
  and the device they lived on), so values cross the socket without an
  intermediate copy on the send side.
* :mod:`repro_torch.cluster.channel` and
  :mod:`repro_torch.cluster.eventloop` — the scheduler-side multiplexed
  connection to one node agent (request/response routing by message id):
  one reader thread per agent (``threads``), or coroutines on one IOLoop
  thread (``async``, the default; DESIGN.md §18).
* :mod:`repro_torch.cluster.agent` — the node agent server
  (``python -m repro_torch.cluster.agent --connect HOST:PORT --workers
  N``): runs task bodies on a spawned process-executor pool and caches
  received data in a node-local object plane keyed by ``(data_id,
  version)``.  It holds host bytes only; its pool workers own the card.
* :mod:`repro_torch.cluster.peer` — the peer-to-peer data plane (DESIGN.md
  §15): every agent serves its node plane over an ephemeral data port,
  and consumers (other agents, or the scheduler on gather) pull
  node-resident results through pooled per-peer connections.
* :mod:`repro_torch.cluster.cluster` — ``LocalCluster``, a harness that
  spawns N agents on localhost so tests and the card's smoke run exercise
  the real multi-node path on one machine.
* :mod:`repro_torch.cluster.chaos` — the seeded fault injector
  (``RJAX_CHAOS``, DESIGN.md §19).

The scheduler-side executor backend lives in
:class:`repro_torch.core.executors.ClusterExecutor` (``backend="cluster"``).
"""
from .cluster import LocalCluster  # noqa: F401
from .peer import PeerFetchError, PeerPool  # noqa: F401
from .protocol import ConnectionClosed  # noqa: F401
