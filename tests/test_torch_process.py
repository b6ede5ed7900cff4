"""The port's process backend: spawned worker processes behind the
shared-memory object plane (``repro_torch.core.executors``).

One module-scoped pool of two spawned workers serves every test (each
spawned worker imports torch, which takes seconds).  The thread-backend
results it is held against are computed first, in a module-scoped
fixture, because the API runs one runtime at a time.  Every comparison is
bitwise: the pipelines, the collectives and every tensor that crosses the
boundary must come back with the same bytes, dtype and device.  The
file imports nothing of the JAX package, so spawned workers that import
it to find its task functions never load JAX.
"""
import hashlib
import os
import signal
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.algorithms import kmeans, knn, linreg  # noqa: E402
from repro_torch.core import api, collectives  # noqa: E402
from repro_torch.core import executors, futures  # noqa: E402
from repro_torch.core.futures import TaskFailedError  # noqa: E402

CPU = "cpu"
KNN = dict(n_train=2400, n_test=600, d=12, k=5, n_classes=4, train_fragments=4,
           test_blocks=2)
KMEANS = dict(n_points=24_000, d=8, k=5, fragments=4, max_iters=4, tol=0.0)
LINREG = dict(n_rows=6000, p=12, n_pred=900, fragments=4, pred_blocks=2)


def _pipelines():
    return {"knn": knn.run_knn(**KNN, device=CPU).predictions,
            "kmeans": kmeans.run_kmeans(**KMEANS, device=CPU),
            "linreg": linreg.run_linreg(**LINREG, device=CPU)}


def _rows(seed, n, d):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((n, d)))


def _by_parity(block, n_out):
    return [block[i::n_out] for i in range(n_out)]


def _collectives():
    blocks = [api.task(_rows, name="rows")(s, 64, 8) for s in range(3)]
    parts = api.wait_on(collectives.shuffle(blocks, _by_parity, 2))
    shared = collectives.broadcast(torch.arange(6000, dtype=torch.float32))
    total = api.wait_on(api.task(lambda v, b: (v * 2).sum() + b.sum(), name="use")(
        shared, blocks[0]))
    return parts, total


@pytest.fixture(scope="module")
def thread_results():
    with api.runtime_start(n_workers=2, backend="thread"):
        return {**_pipelines(), "collectives": _collectives()}


@pytest.fixture(scope="module")
def prt(thread_results):
    rt = api.runtime_start(n_workers=2, backend="process", max_retries=1)
    yield rt
    api.runtime_stop(wait=False)


def test_the_pool_spawns_by_default(prt):
    st = prt.stats()["executor"]
    assert st["backend"] == "process" and st["start_method"] == "spawn"
    assert st["pipeline_depth"] == 4
    assert all(p.is_alive() for p in prt.executor._procs)


@pytest.mark.parametrize("name", ["knn", "kmeans", "linreg"])
def test_pipelines_are_bitwise_equal_to_the_thread_backend(prt, thread_results, name):
    got = _pipelines()[name]
    want = thread_results[name]
    if name == "knn":
        assert got.tobytes() == want.tobytes()
    elif name == "kmeans":
        assert got.centroids.tobytes() == want.centroids.tobytes()
        assert got.sse_history == want.sse_history and got.shifts == want.shifts
    else:
        assert got.beta.tobytes() == want.beta.tobytes()
        assert got.predictions.tobytes() == want.predictions.tobytes()
    st = prt.stats()["executor"]
    assert st["bytes_planed"] > 0 and st["worker_cache_hits"] > 0


def _tensors(seed):
    """Tensors on both sides of the segment threshold (16 KiB)."""
    g = torch.Generator().manual_seed(seed)
    big = torch.randn(64, 128, generator=g)
    return {"fp32": big, "int32": (big * 100).to(torch.int32),
            "bf16": big.to(torch.bfloat16), "small_bf16": big[:2, :8].to(torch.bfloat16),
            "strided": big.t(), "empty": torch.empty(0, 3, dtype=torch.bfloat16)}


def _bytes(v):
    return v.contiguous().view(torch.uint8).numpy().tobytes()


def _describe(values):
    return {k: (str(v.dtype), v.device.type, tuple(v.shape), hashlib.sha1(_bytes(v)).hexdigest())
            for k, v in values.items()}


@pytest.mark.parametrize("seed", [0, 1])
def test_tensors_cross_with_their_dtype_and_device(prt, seed):
    made = api.task(_tensors, name="tensors")(seed)
    described = api.task(_describe, name="describe")(made)   # read in a worker
    got = api.wait_on(made)
    want = _tensors(seed)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].device == v.device, k
        assert _bytes(got[k]) == _bytes(v), k
    assert api.wait_on(described) == _describe(want)
    # the segment-sized leaves of the datum went into the plane under
    # keys derived from the datum's own key
    keys = [k for k in prt.executor.plane._by_key if len(k) == 3]
    assert {k[2] for k in keys} >= {"fp32", "int32", "bf16"}


def test_a_card_result_waits_as_host_bytes_until_it_is_read():
    """The parent keeps a worker's card tensor as its host view and
    uploads it at the first read, once; re-planing it keeps its device
    (the ``meta`` device stands in for the card on the CPU)."""
    x = torch.arange(16_384, dtype=torch.float32).to(torch.bfloat16)
    seg, ref = executors._value_to_segment(x)
    ref.device = "meta"
    plane = executors.SegmentPlane()
    try:
        value, fresh = plane.attach(ref)
        assert fresh and isinstance(value, executors.CardResult)
        assert value.host.device.type == "cpu" and torch.equal(value.host, x)
        assert value.nbytes == x.numel() * 2
        out = futures.materialize((value, [value], {"n": 1}))
        assert out[0].device.type == "meta" and out[0].dtype == torch.bfloat16
        assert out[0].shape == x.shape and out[1][0] is out[0]   # uploaded once
        plain = (1, [np.zeros(2)], {"a": x})
        assert futures.materialize(plain) is plain
        seg2, ref2 = executors._value_to_segment(value)
        assert ref2.device == "meta" and ref2.torch_dtype == "bfloat16"
        assert torch.equal(executors._segment_host_view(seg2, ref2), x)
        executors._dispose_segment(seg2, unlink=True)
    finally:
        plane.close()
        executors._dispose_segment(seg, unlink=True)


def test_fork_after_cuda_initialisation_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="fork"):
        executors.start_method("fork")
    with pytest.raises(RuntimeError, match="fork"):
        executors.ProcessExecutor(2, mp_context="fork")
    assert executors.start_method(None) == "spawn"


def test_a_worker_that_cannot_reach_the_card_fails_its_task(prt):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    fut = api.task(knn.knn_fill_fragment, name="fill_on_card")(0, 10, 4, 2, "cuda")
    with pytest.raises(TaskFailedError) as err:
        api.wait_on(fut)
    assert "CUDA is not available" in str(err.value.cause)


def _slow_rows(seed, n, delay):
    time.sleep(delay)
    return np.random.default_rng(seed).standard_normal(n)


def test_sigkill_mid_task_retries_to_the_same_bytes(prt):
    ex = prt.executor
    restarts = ex.worker_restarts
    fut = api.task(_slow_rows, name="slow_rows", max_retries=1)(7, 5000, 1.0)
    killed = []

    def killer():
        deadline = time.time() + 20
        while time.time() < deadline and not killed:
            for w in range(ex.n_workers):
                if ex.running_task(w) == "slow_rows":
                    time.sleep(0.3)   # the body is asleep inside the worker
                    os.kill(ex.worker_pids[w], signal.SIGKILL)
                    killed.append(w)
                    break
            time.sleep(0.01)

    t = threading.Thread(target=killer)
    t.start()
    got = api.wait_on(fut, timeout=60)
    t.join()
    assert killed, "the task never reached a worker"
    assert got.tobytes() == _slow_rows(7, 5000, 0).tobytes()
    assert ex.worker_restarts == restarts + 1
    assert prt.stats()["retries"] >= 1


def test_broadcast_and_shuffle_equal_their_thread_results(prt, thread_results):
    parts, total = _collectives()
    want_parts, want_total = thread_results["collectives"]
    assert len(parts) == 2
    for got, want in zip(parts, want_parts):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(total, want_total)


def test_dev_shm_is_left_clean(prt):
    """Last in the module: stop the pool and check that no segment the
    plane held (inputs and adopted results alike) is left in /dev/shm."""
    plane = prt.executor.plane
    names = set(plane._by_name)
    assert names, "the plane held no segment"
    api.runtime_stop()
    left = {n for n in names if os.path.exists(os.path.join("/dev/shm", n))}
    assert not left, f"segments left behind: {sorted(left)}"
    assert not any(p.is_alive() for p in prt.executor._procs)
