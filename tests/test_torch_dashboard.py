"""The port's live dashboard (``repro_torch.core.dashboard``) on a live
thread-backend run and a live process-backend run (two spawned workers),
mirroring the dashboard cases of ``tests/test_telemetry.py``: every
endpoint answers over HTTP, and what it serves agrees with the runtime's
own ledgers.  The file imports nothing of the JAX package."""
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import api  # noqa: E402


def _get_json(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def _gen(seed, n):
    return np.random.default_rng(seed).standard_normal(n)


def _tot(a, b):
    return float(np.sum(a) + np.sum(b))


@pytest.fixture(scope="module", params=["thread", "process"])
def dash_rt(request):
    rt = api.runtime_start(n_workers=2, backend=request.param, dashboard_port=0)
    yield rt
    api.runtime_stop(wait=False)


def _run_some_tasks():
    gen, tot = api.task(_gen, name="gen"), api.task(_tot, name="tot")
    frags = [gen(i, 4096) for i in range(6)]
    outs = [tot(frags[i], frags[(i + 1) % 6]) for i in range(6)]
    return api.wait_on(outs)


def test_the_dashboard_serves_and_the_sampler_beats(dash_rt):
    assert dash_rt.dashboard.url.startswith("http://127.0.0.1:")
    assert dash_rt.telemetry.enabled
    _run_some_tasks()
    deadline = time.time() + 10
    while time.time() < deadline and not dash_rt.telemetry.nodes():
        time.sleep(0.05)
    payload = dash_rt.telemetry.nodes()["local"]["payload"]
    assert payload["backend"] == dash_rt.backend and payload["sampled"]


def test_api_status(dash_rt):
    _run_some_tasks()
    st = _get_json(dash_rt.dashboard.url + "api/status")
    assert st["backend"] == dash_rt.backend and st["n_workers"] == 2
    assert st["workers_per_node"] == (1 if dash_rt.backend == "process" else 2)
    stats = dash_rt.stats()
    assert st["tasks"]["done"] == stats["tasks_done"]
    assert st["tasks"]["submitted"] == stats["tasks_submitted"]
    assert st["tasks"]["failed"] == stats["tasks_failed"] == 0
    assert st["ring"]["seq"] > 0 and "local" in st["nodes"]


def test_api_tasks_streams_ring(dash_rt):
    _run_some_tasks()
    tk = _get_json(dash_rt.dashboard.url + "api/tasks?since=0")
    kinds = {e["kind"] for e in tk["events"]}
    assert {"submit", "dispatch", "done"} <= kinds
    assert tk["last_seq"] == dash_rt.telemetry.stream.last_seq
    done = [e for e in tk["events"] if e["kind"] == "done"]
    assert len(done) == dash_rt.stats()["tasks_done"]
    assert all(e["t1"] >= e["t0"] for e in done)
    assert any(e.get("t_run") is not None for e in done)
    # incremental polling: nothing new past the watermark
    again = _get_json(dash_rt.dashboard.url + f"api/tasks?since={tk['last_seq']}")
    assert again["events"] == []
    capped = _get_json(dash_rt.dashboard.url + "api/tasks?since=0&limit=3")
    assert len(capped["events"]) == 3


def test_api_transfers_matches_ledger(dash_rt):
    _run_some_tasks()
    tr = _get_json(dash_rt.dashboard.url + "api/transfers")
    d = dash_rt.store.transfer_detail()
    assert tr["p2p_bytes"] == d["p2p_bytes"] == 0      # no cluster: no peer plane
    assert tr["scheduler_relay_bytes"] == d["scheduler_relay_bytes"]
    assert tr["transfers"] == d["transfers"]
    assert sum(e["bytes"] for e in tr["matrix"]) == sum(e["bytes"] for e in d["matrix"])


def test_api_trace_and_page(dash_rt):
    _run_some_tasks()
    doc = _get_json(dash_rt.dashboard.url + "api/trace")
    assert len([r for r in doc["traceEvents"] if r["ph"] == "X"]) > 0
    with urllib.request.urlopen(dash_rt.dashboard.url, timeout=10) as resp:
        assert resp.status == 200
        assert b"Task stream" in resp.read()


def test_api_404(dash_rt):
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(dash_rt.dashboard.url + "nope", timeout=10)

