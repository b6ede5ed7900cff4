"""repro_torch.core — the task runtime of the paper, copied from the JAX
package's pure-Python runtime and trimmed to the thread backend.

A COMPSs-style dynamic task-based runtime: sequential user code, automatic
dependency detection, asynchronous scheduling over persistent executors,
fault tolerance and tracing.  Task results may be CUDA tensors: under the
thread backend they stay on the device from producer to consumer.
"""
from .api import (  # noqa: F401
    barrier,
    compss_barrier,
    compss_start,
    compss_stop,
    compss_wait_on,
    current_runtime,
    runtime_start,
    runtime_stop,
    task,
    wait_on,
)
from .dag import TaskGraph, TaskNode, TaskState  # noqa: F401
from .fault import PoisonedInputError, RetryPolicy, SpeculationConfig  # noqa: F401
from .futures import Future, ObjectStore, TaskFailedError  # noqa: F401
from .runtime import Runtime  # noqa: F401
from .tracing import TraceEvent, Tracer  # noqa: F401
