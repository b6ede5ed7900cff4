"""Runtime collectives: tree-reduce, broadcast, shuffle (DESIGN.md §16),
the port's copy.

``tree_reduce``
    Schedules a balanced k-ary merge tree over Futures.  Each tree node is
    ONE task that folds up to ``arity`` children with a balanced in-task
    binary fold — so a 128-leaf reduction at arity 8 costs 19 dispatches
    over 3 levels instead of 127 dispatches over 7, while performing the
    exact same pairwise merges in the exact same order as the client-side
    ``algorithms.common.tree_reduce``: results are bitwise identical, not
    merely numerically close.  Every merge carries a placement hint
    pinning it to the node where its largest child is resident.

``broadcast``
    Fans a keyed datum out to every cluster agent over the §15 peer data
    plane: ONE copy crosses the scheduler's own link (to a root agent),
    the rest moves agent→agent in a doubling frontier — a binomial tree in
    which every agent that holds the bytes immediately becomes a source
    for one that does not.  A tensor crosses as host bytes (a tensor
    frame) and stays host bytes on every agent.  On the thread and
    process backends it degrades to a plain keyed store put.

``shuffle``
    All-to-all repartition of a fragment set: each input fragment is split
    into ``n_out`` keyed pieces by a user partition function, and piece
    ``p`` of every fragment is combined into output partition ``p``
    (ndarray rows concatenated, tensor rows ``torch.cat``-ed).  Every
    piece is a task result, so on the cluster backend the pieces stay
    node-resident and move agent→agent to the node that combines them.

The shape helpers (``reduce_spec`` / ``spec_depth``) describe exactly
what the runtime schedules.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .executors import _dumps_fn, _loads_fn
from .futures import Future

__all__ = [
    "broadcast",
    "reduce_spec",
    "shuffle",
    "spec_depth",
    "tree_reduce",
]


# --------------------------------------------------------------------- shapes
def reduce_spec(n_leaves: int, arity: int = 2) -> List[Tuple[int, Tuple[int, ...]]]:
    """Shape of the collective reduction: merge nodes as
    ``(merge_index, children)`` where each merge folds 2..``arity``
    children and children ``>= n_leaves`` refer to merge node
    ``child - n_leaves``.  Merges appear in dependency order.  For
    ``arity=2`` this is exactly the balanced binary
    ``algorithms.common.tree_reduce_spec`` shape."""
    if arity < 2:
        raise ValueError(f"reduce arity must be >= 2, got {arity}")
    ids = list(range(n_leaves))
    merges: List[Tuple[int, Tuple[int, ...]]] = []
    next_id = n_leaves
    while len(ids) > 1:
        nxt = []
        for i in range(0, len(ids), arity):
            group = ids[i : i + arity]
            if len(group) == 1:
                nxt.append(group[0])
                continue
            merges.append((next_id - n_leaves, tuple(group)))
            nxt.append(next_id)
            next_id += 1
        ids = nxt
    return merges


def spec_depth(merges: Sequence[Tuple[int, Tuple[int, ...]]],
               n_leaves: int) -> int:
    """Critical-path length (in merge nodes) of a reduction spec — works
    on both :func:`reduce_spec` and ``common.tree_reduce_spec`` output."""
    depth: dict = {}
    for mi, children in merges:
        depth[n_leaves + mi] = 1 + max(
            (depth.get(c, 0) for c in children), default=0)
    return max(depth.values(), default=0)


class _Fn:
    """Self-contained callable for shipping as a task *argument*.

    Task functions cross address spaces through the fn registry, which
    cloudpickles ``__main__`` functions and closures by value — but the
    collectives pass the user's merge/partition callable inside the task
    args, which ride plain pickle and would resolve ``__main__`` *by
    reference* in an agent whose ``__main__`` is the agent module.  This
    wrapper pickles as the ``_dumps_fn`` blob (computed once per
    collective) and rehydrates lazily on first call."""

    __slots__ = ("blob", "_fn")

    def __init__(self, fn: Callable):
        self.blob = _dumps_fn(fn)
        self._fn: Optional[Callable] = fn

    def __call__(self, *args, **kwargs):
        fn = self._fn
        if fn is None:
            fn = self._fn = _loads_fn(self.blob)
        return fn(*args, **kwargs)

    def __getstate__(self):
        return self.blob

    def __setstate__(self, blob):
        self.blob = blob
        self._fn = None


# ------------------------------------------------------------------ reduction
def _balanced_fold(fn: Callable, vals: Sequence) -> Any:
    """Pairwise-halving fold — the same merge order ``tree_reduce_spec``
    emits for one arity group, so in-task and cross-task reductions of
    the same leaves produce bitwise-identical results."""
    vals = list(vals)
    while len(vals) > 1:
        paired = [fn(vals[j], vals[j + 1])
                  for j in range(0, len(vals) - 1, 2)]
        if len(vals) % 2:
            paired.append(vals[-1])
        vals = paired
    return vals[0]


def _group_merge(fn: Callable, *vals):
    """Task body for one k-ary tree node: balanced fold of the user's
    binary merge over up to ``arity`` children."""
    return _balanced_fold(fn, vals)


def tree_reduce(items: Sequence, merge, arity: int = 2):
    """Reduce ``items`` through a balanced k-ary tree of merge tasks.

    ``merge`` is the binary merge as an ``api.task``-decorated
    TaskFunction (its plain ``.fn`` runs inside each tree node); a bare
    callable gets a client-side balanced fold with no tasks submitted.
    Returns the Future of the root (or the folded value)."""
    from . import api

    items = list(items)
    if not items:
        raise ValueError("tree_reduce of empty sequence")
    if arity < 2:
        raise ValueError(f"tree_reduce arity must be >= 2, got {arity}")
    if len(items) == 1:
        return items[0]

    if not isinstance(merge, api.TaskFunction):
        # client-side fold, same overall binary shape as the task tree
        vals = list(items)
        for _, children in reduce_spec(len(items), arity):
            vals.append(_balanced_fold(merge, [vals[c] for c in children]))
        return vals[-1]

    if merge.returns != 1:
        raise ValueError("tree_reduce merge task must return exactly 1 value")
    rt = api.current_runtime()
    store = rt.store
    fn = _Fn(merge.fn)

    # per-leaf residency snapshot feeding the placement hints: merges are
    # pinned where their largest child lives (DESIGN.md §16); unknown
    # homes (unfinished leaves, plain values) leave placement to the
    # dynamic locality score
    sizes: List[int] = []
    homes: List[Optional[int]] = []
    for it in items:
        if isinstance(it, Future):
            sizes.append(store.nbytes(it.key))
            locs = store.locations(it.key)
            homes.append(min(locs) if locs else None)
        else:
            try:
                sizes.append(int(getattr(it, "nbytes", 0)))
            except Exception:
                sizes.append(0)
            homes.append(None)

    vals: List[Any] = list(items)
    for _, children in reduce_spec(len(items), arity):
        group = [vals[c] for c in children]
        gsizes = [sizes[c] for c in children]
        big = max(range(len(children)), key=lambda i: gsizes[i])
        hint = homes[children[big]]
        name = merge.name if len(group) == 2 else f"{merge.name}x{len(group)}"
        out = rt.submit(
            _group_merge, (fn, *group), name=name,
            max_retries=merge.max_retries, priority=merge.priority,
            speculatable=merge.speculatable, placement_hint=hint,
        )
        vals.append(out)
        # a merge of same-shaped partials is partial-sized, not sum-sized
        sizes.append(max(gsizes) if gsizes else 0)
        homes.append(hint)
    return vals[-1]


# ------------------------------------------------------------------ broadcast
def broadcast(value: Any) -> Future:
    """Publish ``value`` under a fresh datum key on every node.

    On the cluster backend the bytes cross the scheduler link once (to a
    root agent) and then move agent→agent through the peer data plane in
    a doubling frontier; every agent ends with the key resident, so tasks
    consuming the returned Future never trigger a per-agent Put.  On the
    thread and process backends the value is stored client-side (a
    process worker then reads it through the shared-memory plane, once
    per worker).  Accepts a Future (materialized first) or a plain
    value."""
    from . import api

    rt = api.current_runtime()
    if isinstance(value, Future):
        value = rt.wait_on(value)
    store = rt.store
    key = (store.new_data_id(), 1)
    store.put(key, value)
    fan = getattr(rt.executor, "broadcast", None)
    if fan is not None:
        fan(key, value, store)
    # producer task 0 never exists: graph ids start at 1, and the store
    # already holds the value, so dependents are immediately ready
    return Future(key[0], key[1], 0, store)


# -------------------------------------------------------------------- shuffle
def _split_fragment(partition_fn: Callable, frag, n_out: int):
    parts = list(partition_fn(frag, n_out))
    if len(parts) != n_out:
        raise ValueError(
            f"partition_fn returned {len(parts)} pieces, expected {n_out}")
    return tuple(parts) if n_out > 1 else parts[0]


def _concat_parts(*parts):
    if parts and all(isinstance(p, np.ndarray) for p in parts):
        return np.concatenate(parts)
    if parts and all(isinstance(p, torch.Tensor) for p in parts):
        return torch.cat(parts)
    out: list = []
    for p in parts:
        out.extend(p)
    return out


def shuffle(fragments: Sequence, partition_fn: Callable, n_out: int,
            combine=None) -> List:
    """All-to-all repartition: split every fragment into ``n_out`` pieces
    with ``partition_fn(frag, n_out)`` and combine piece ``p`` of every
    fragment into output partition ``p``.

    ``combine`` is an optional binary TaskFunction merged via
    :func:`tree_reduce`; by default pieces are concatenated (ndarray
    or tensor rows) or flattened into a list.  Returns ``n_out`` Futures."""
    from . import api

    rt = api.current_runtime()
    fragments = list(fragments)
    if not fragments:
        raise ValueError("shuffle of empty fragment set")
    if n_out < 1:
        raise ValueError(f"shuffle n_out must be >= 1, got {n_out}")

    rows = []
    part = _Fn(partition_fn)
    for frag in fragments:
        pieces = rt.submit(_split_fragment, (part, frag, n_out),
                           name="shuffle_split", returns=n_out)
        rows.append(pieces if isinstance(pieces, tuple) else (pieces,))

    outs: List = []
    for p in range(n_out):
        col = [row[p] for row in rows]
        if combine is not None:
            outs.append(tree_reduce(col, combine,
                                    arity=max(2, min(len(col), 4))))
        elif len(col) == 1:
            outs.append(col[0])
        else:
            outs.append(rt.submit(_concat_parts, tuple(col),
                                  name="shuffle_concat"))
    return outs
