"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run (``runner.run_cell`` on the CPU, tiny sizes, the thread backend),
with one fault planted in the port's task bodies:

* a step that returns its state unchanged: K-means' update hands back
  the centroids it got; KNN's merge hands back its first input;
* half of the batch left out: ``partial_sum`` over the first half of a
  fragment's points (the means taken over the rest); ``KNN_frag`` over
  the first half of a fragment's rows;
* an answer altered where it is produced: one sse of ``update_centroids``
  off by a part in 10^4; every vote of ``KNN_classify`` moved to the
  next class.

The exchange between chips has no fault to plant: every cell runs on
one card.
"""
from __future__ import annotations

import time

import pytest

from bench.harness import runner
from bench.tests.tiny import tiny_cell

torch = pytest.importorskip("torch")


def _run(name):
    return runner.run_cell(tiny_cell(name), 2 ** 31 + 99, 0.3, False, "cpu",
                           time.perf_counter())


def test_a_sound_run_is_correct():
    assert _run("kmeans_d50.paper")["correct"]
    assert _run("knn_d50.paper")["correct"]


def _kmeans_unchanged(km):
    plain = km.update_centroids

    def update_centroids(acc, old):
        new, shift, sse = plain(acc, old)
        return old, shift, sse
    return "update_centroids", update_centroids


def _kmeans_half(km):
    plain = km.partial_sum

    def partial_sum(X, centroids):
        return plain(X[: X.shape[0] // 2], centroids)
    return "partial_sum", partial_sum


def _kmeans_altered(km):
    plain = km.update_centroids

    def update_centroids(acc, old):
        new, shift, sse = plain(acc, old)
        return new, shift, sse * (1 + 1e-4)
    return "update_centroids", update_centroids


def _knn_unchanged(knn):
    return "knn_merge", lambda a, b: a


def _knn_half(knn):
    plain = knn.knn_frag

    def knn_frag(frag, test_X, k):
        X, y = frag
        half = X.shape[0] // 2
        return plain((X[:half], y[:half]), test_X, k)
    return "knn_frag", knn_frag


def _knn_altered(knn):
    plain = knn.knn_classify

    def knn_classify(merged, n_classes):
        return (plain(merged, n_classes) + 1) % n_classes
    return "knn_classify", knn_classify


@pytest.mark.parametrize("fault", [_kmeans_unchanged, _kmeans_half, _kmeans_altered])
def test_a_kmeans_fault_fails_the_check(monkeypatch, fault):
    from repro_torch.algorithms import kmeans
    name, body = fault(kmeans)
    monkeypatch.setattr(kmeans, name, body)
    out = _run("kmeans_d50.paper")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_knn_unchanged, _knn_half, _knn_altered])
def test_a_knn_fault_fails_the_check(monkeypatch, fault):
    from repro_torch.algorithms import knn
    name, body = fault(knn)
    monkeypatch.setattr(knn, name, body)
    out = _run("knn_d50.bulk")
    assert not out["correct"], out["checks"]
