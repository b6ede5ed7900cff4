"""Logical-axis sharding rules → partition specs → DTensor placements: the
port of ``repro/distributed/sharding.py``.

Every parameter has a tuple of logical axis names
(:func:`repro_torch.models.lm.param_axes`, keyed by parameter name).  A
:class:`ShardingRules` table maps logical names to mesh axes;
:func:`param_pspecs` applies it with the reference's divisibility check
(a dim is sharded only where its size divides evenly — MQA's single KV
head stays replicated) and its never-twice rule (no mesh axis shards two
dims of one tensor).

Default placement on the ``(data, model)`` mesh of
:func:`repro_torch.launch.mesh.make_local_mesh`:

* batch over ``data`` — data parallelism;
* ``heads/mlp/vocab/expert/ssm_*/rnn`` over ``model``;
* ``embed`` (the weights' d_model dim) over ``data`` — FSDP storage;
* ``expert_mlp`` (per-expert d_ff) over ``data`` — FSDP storage;
* optimizer moments inherit the parameter specs.

A spec is a :class:`P`: one entry per tensor dim, ``None`` (replicated),
a mesh axis name, or a tuple of names.  :func:`to_placements` turns it
into the DTensor placements of a mesh, one per mesh dim (``Shard(dim)`` /
``Replicate()``); a dim over two mesh axes arises only with the
reference's multi-pod ``pod`` axis, which no local mesh has, and raises.
The functions read a mesh's ``mesh_dim_names`` and ``shape`` only, so
they take a ``DeviceMesh`` or, host-side with no process group, a
:class:`MeshShape`.  ``torch.distributed.tensor`` is imported where a
placement is built, not with this module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: ``P("data", None)`` shards dim 0 over ``data`` and
    replicates dim 1 (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes with no devices behind them (the
    reference's ``AbstractMesh``): for placement logic alone."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


@dataclass(frozen=True)
class ShardingRules:
    table: Dict[str, MeshAxes] = field(default_factory=dict)

    def lookup(self, name: Optional[str]) -> MeshAxes:
        if name is None:
            return None
        return self.table.get(name)

    def override(self, **kw) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return ShardingRules(t)


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def default_rules(mesh) -> ShardingRules:
    names = _names(mesh)
    dp: Tuple[str, ...] = tuple(a for a in ("pod", "data") if a in names)
    fsdp = "data" if "data" in names else None
    return ShardingRules({
        "batch": dp,
        "vocab": "model",
        "embed": fsdp,          # FSDP storage of the d_model dim
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "mlp": "model",
        "expert": "model",      # EP
        "expert_mlp": fsdp,     # FSDP storage
        "expert_router": None,
        "ssm_inproj": "model",
        "ssm_conv": "model",
        "ssm_heads": "model",
        "ssm_inner": "model",
        "rnn": "model",
        "layers": None,
        "seq": None,
    })


def _axis_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def spec_for(shape: Tuple[int, ...], logical: Tuple[Optional[str], ...],
             rules: ShardingRules, mesh) -> P:
    """The spec of one tensor; respects divisibility and never assigns the
    same mesh axis twice."""
    assert len(shape) == len(logical), (shape, logical)
    names = _names(mesh)
    used: set = set()
    dims = []
    for size, name in zip(shape, logical):
        axes = rules.lookup(name)
        if axes is None:
            dims.append(None)
            continue
        ax_tuple = (axes,) if isinstance(axes, str) else tuple(axes)
        ax_tuple = tuple(a for a in ax_tuple if a in names and a not in used)
        if not ax_tuple or size % _axis_size(mesh, ax_tuple) != 0:
            dims.append(None)
            continue
        used.update(ax_tuple)
        dims.append(ax_tuple[0] if len(ax_tuple) == 1 else ax_tuple)
    return P(*dims)


def _shape(x) -> Tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def param_pspecs(axes: Mapping[str, Tuple], shapes: Mapping[str, Any], rules: ShardingRules,
                 mesh) -> Dict[str, P]:
    """{parameter name: spec}: ``axes`` as :func:`param_axes` gives them,
    ``shapes`` tensors (meta ones will do) or shapes under the same names."""
    assert set(axes) == set(shapes), sorted(set(axes) ^ set(shapes))
    return {n: spec_for(_shape(shapes[n]), axes[n], rules, mesh) for n in shapes}


def _tree_map(fn, tree, name: Optional[str] = None):
    """``fn(leaf, name)`` over nested dicts, lists and tuples; ``name`` is
    the nearest dict key above the leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v, name) for v in tree)
    return fn(tree, name)


def batch_pspecs(batch_tree, rules: ShardingRules, mesh):
    """Shard dim 0 (batch) of every input over the DP axes; replicate the
    rest (everything where the batch does not divide)."""
    dp = rules.lookup("batch")

    def one(x, _name):
        ndim = len(_shape(x))
        if ndim == 0:
            return P()
        if _shape(x)[0] % _axis_size(mesh, dp) == 0 and _axis_size(mesh, dp) > 1:
            return P(dp if not isinstance(dp, tuple) or len(dp) > 1 else dp[0],
                     *([None] * (ndim - 1)))
        return P(*([None] * ndim))

    return _tree_map(one, batch_tree)


def cache_pspecs(cache_tree, rules: ShardingRules, mesh):
    """Decode / prefill caches, keyed by leaf name (``k`` / ``v`` /
    ``pos_map`` / ``conv`` / ``state`` / ``h``); a leading layers dim, as
    the reference's stacked caches have, is left replicated."""
    dp = rules.lookup("batch")
    model = "model" if "model" in _names(mesh) else None

    def shard_dim(size, axes):
        if axes is None:
            return None
        if size % _axis_size(mesh, axes) != 0 or _axis_size(mesh, axes) == 1:
            return None
        if isinstance(axes, tuple) and len(axes) == 1:
            return axes[0]
        return axes

    def one(x, name):
        shape = _shape(x)
        ndim = len(shape)
        dims = [None] * ndim
        if name in ("k", "v"):           # (B, Sc, K, hd)
            b, kvh, hd = ndim - 4, ndim - 2, ndim - 1
            dims[b] = shard_dim(shape[b], dp)
            dims[kvh] = shard_dim(shape[kvh], model)
            if dims[kvh] is None:
                # MQA / few KV heads: shard head_dim instead
                dims[hd] = shard_dim(shape[hd], model)
        elif name == "conv":             # (B, W, C)
            b, c = ndim - 3, ndim - 1
            dims[b] = shard_dim(shape[b], dp)
            dims[c] = shard_dim(shape[c], model)
        elif name == "state":            # (B, H, P, N)
            b, h = ndim - 4, ndim - 3
            dims[b] = shard_dim(shape[b], dp)
            dims[h] = shard_dim(shape[h], model)
        elif name == "h":                # (B, R)
            dims[ndim - 2] = shard_dim(shape[ndim - 2], dp)
            dims[ndim - 1] = shard_dim(shape[ndim - 1], model)
        return P(*dims)                  # pos_map and the rest: replicated

    return _tree_map(one, cache_tree)


def to_placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the spec puts tensor dim ``d`` over that axis,
    else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    placements = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        if len(axes) != 1:
            raise ValueError(f"dim {dim} of {spec} spans mesh axes {axes}: a local mesh has "
                             f"no 'pod' axis, and a DTensor shards a dim over one mesh dim")
        placements[names.index(axes[0])] = Shard(dim)
    return placements


@dataclass(frozen=True)
class Sharding:
    """Where one tensor lives: a ``DeviceMesh`` and its placements (the
    reference's ``NamedSharding``)."""
    mesh: Any
    placements: Tuple

    def place(self, full):
        """``full`` (the same on every rank) as a DTensor; each rank keeps
        its shard, with no communication."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(full.to(self.mesh.device_type), self.mesh,
                                 list(self.placements), src_data_rank=None)


def to_shardings(spec_tree, mesh):
    """Each :class:`P` of a tree of dicts, lists and NamedTuples as a
    :class:`Sharding` on ``mesh``."""
    if isinstance(spec_tree, P):
        return Sharding(mesh, tuple(to_placements(spec_tree, mesh)))
    if isinstance(spec_tree, dict):
        return {k: to_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(to_shardings(v, mesh) for v in spec_tree))
    if isinstance(spec_tree, list):
        return [to_shardings(v, mesh) for v in spec_tree]
    return spec_tree
