"""Logical-axis sharding (a MaxText-style rules table), as
``repro.distributed.sharding`` has it, over a torch ``DeviceMesh``.

Model code never names mesh axes: tensors are annotated with *logical* axes
("batch", "embed", "heads", "experts", ...) and a rules table maps those to
mesh axes.  Switching the parallelism layout is switching the rules table.

A mesh here is either a ``torch.distributed.device_mesh.DeviceMesh`` whose
dims are named (``mesh_dim_names``), or an :class:`AbstractMesh`, sizes and
names with no process group (the counterpart of
``jax.sharding.AbstractMesh``), which is enough to build specs.

A :class:`PartitionSpec` is a tuple whose entries are ``None``, a mesh axis
name, or a tuple of names, with the trailing ``None`` s trimmed, as JAX's
``P`` reads.  A :class:`NamedSharding` pairs it with a mesh and gives the
DTensor placements (one a mesh dim).  A tensor dim mapped to two mesh axes
(``experts_ep`` -> ``("data", "model")``) is split row-major with the first
named axis outermost, as JAX splits it; DTensor's ``(Shard(d), Shard(d))``
over those mesh dims gives the same block to the same coordinate when the
axes are named in the mesh's own dim order, and a spec that names them in
another order is refused.

Divisibility fallback: a logical axis whose dimension does not divide the
mapped mesh axes is replicated (e.g. kv_heads=8 on a 16-way model axis),
exactly as the JAX package degrades it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# data-parallel submesh: "pod" is the slowest axis so DP gradients reduce
# hierarchically (intra-pod reduce-scatter, inter-pod all-reduce).
DP_AXES = ("pod", "data")

DEFAULT_RULES: Rules = {
    "batch": DP_AXES,
    "seq": None,
    "kv_seq": None,
    "embed": DP_AXES,        # weights' d_model dim => FSDP (ZeRO-3 style)
    "act_embed": None,       # activations' d_model dim stays unsharded
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": "model",
    "experts_ep": ("data", "model"),  # EP: experts stationary over the mesh
    "expert_fsdp": ("pod",),          # EP weights' inner dim: ZeRO-3 over pod
    "expert_mlp": None,
    "lru": "model",
    "lora": None,
    "conv": None,
    "stack": None,           # the stacked layer axis
    None: None,
}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices or process group."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes {self.axis_names}")


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{axis name: size}`` of a named ``DeviceMesh`` or an
    :class:`AbstractMesh`, in the mesh's dim order."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.axis_sizes))
    names = getattr(mesh, "mesh_dim_names", None)
    if not names:
        raise ValueError("a DeviceMesh for logical sharding needs mesh_dim_names")
    return dict(zip(names, mesh.shape))


class PartitionSpec(tuple):
    """A tuple of ``None``, an axis name, or a tuple of names, one per
    tensor dim (trailing ``None`` s trimmed), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec over a mesh; ``placements`` are DTensor's, one a mesh dim."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        out: list = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"{self.spec}: dim {dim} names {axes} out of the mesh's "
                                 f"dim order {tuple(names)}")
            for i in order:
                out[i] = Shard(dim)
        return tuple(out)


class _Ctx(threading.local):
    mesh: Any = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def logical_sharding(mesh: Any, rules: Optional[Rules] = None):
    """Activate sharding annotations inside model code."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh() -> Any:
    """The mesh of the innermost active :func:`logical_sharding`, or None."""
    return _CTX.mesh


def mesh_axis_size(mesh: Any, axes: Union[None, str, Tuple[str, ...]]) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    size = 1
    for a in axes:
        size *= shape[a] if a in shape else 1
    return size


def spec_for(
    logical_axes: Sequence[Optional[str]],
    shape: Optional[Sequence[int]] = None,
    *,
    mesh: Any = None,
    rules: Optional[Rules] = None,
    strict: bool = True,
) -> PartitionSpec:
    """PartitionSpec for a tensor given its logical axes.

    ``strict=True`` (argument shardings) requires even divisibility.
    ``strict=False`` (activation constraints) only requires dim >= mesh
    extent.  A tuple of axes that does not fit drops its leading axes until
    the dim fits."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules or DEFAULT_RULES
    names = mesh_shape(mesh) if mesh is not None else None
    out = []
    used: set = set()
    for i, ax in enumerate(logical_axes):
        mapped = rules.get(ax, None)
        if mapped is None:
            out.append(None)
            continue
        axes_t = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        axes_t = tuple(a for a in axes_t if names is None or a in names)
        if not axes_t or any(a in used for a in axes_t):
            out.append(None)
            continue
        if shape is not None and mesh is not None:
            # degrade gracefully: drop leading axes until the dim divides
            # (e.g. experts=16 on ("data","model") -> ("model",))
            while axes_t:
                size = mesh_axis_size(mesh, axes_t)
                bad = (shape[i] % size != 0) if strict else (shape[i] < size)
                if not bad:
                    break
                axes_t = axes_t[1:]
            if not axes_t:
                out.append(None)
                continue
        used.update(axes_t)
        out.append(axes_t if len(axes_t) > 1 else axes_t[0])
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def shard(x: Any, *logical_axes: Optional[str]) -> Any:
    """Constrain an activation's layout: a DTensor is redistributed to the
    non-strict spec's placements; a plain tensor, or any tensor outside
    :func:`logical_sharding`, passes unchanged."""
    if _CTX.mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    spec = spec_for(logical_axes, x.shape, strict=False)
    return x.redistribute(x.device_mesh, NamedSharding(_CTX.mesh, spec).placements)


def is_axes(node: Any) -> bool:
    """A logical-axes leaf: a tuple of ``None`` and axis names."""
    return isinstance(node, tuple) and all(a is None or isinstance(a, str) for a in node)


def leaf_shape(node: Any) -> Tuple[int, ...]:
    """The shape of a tensor, an array, or a ``(shape, dtype)`` pair."""
    if hasattr(node, "shape"):
        return tuple(node.shape)
    return tuple(node[0])


def map_axes(fn, logical_tree: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` at every logical-axes leaf of ``logical_tree``,
    with the nodes of ``trees`` at the same place (dicts by key, lists and
    tuples by index); ``None`` stays ``None``."""
    if logical_tree is None:
        return None
    if is_axes(logical_tree):
        return fn(logical_tree, *trees)
    if isinstance(logical_tree, dict):
        return {k: map_axes(fn, v, *(t[k] for t in trees)) for k, v in logical_tree.items()}
    return type(logical_tree)(map_axes(fn, v, *(t[i] for t in trees))
                              for i, v in enumerate(logical_tree))


def tree_spec(
    logical_tree: Any,
    shape_tree: Any,
    *,
    mesh: Any,
    rules: Optional[Rules] = None,
) -> Any:
    """Map a tree of logical-axis tuples (and the matching tensors or
    ``(shape, dtype)`` pairs) to NamedShardings, strict."""
    rules = rules or DEFAULT_RULES
    return map_axes(lambda axes, leaf: NamedSharding(
        mesh, spec_for(axes, leaf_shape(leaf), mesh=mesh, rules=rules)),
        logical_tree, shape_tree)


def axis_group(mesh: Any, axes: Union[str, Tuple[str, ...]]):
    """The process group over mesh axes ``axes`` (one name or a tuple) at
    this rank's coordinate; a tuple's group ranks run row-major over the
    axes in the mesh's dim order.  Raises ``ValueError`` for an abstract mesh
    or an axis the mesh does not have."""
    if isinstance(mesh, AbstractMesh):
        raise ValueError(f"an AbstractMesh {mesh.axis_names} has no process group")
    names = tuple(mesh_shape(mesh))
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in axes if a not in names]
    if unknown or not axes:
        raise ValueError(f"axis {unknown or axes} is not an axis of the mesh {names}")
    axes = tuple(a for a in names if a in axes)  # the mesh's order
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()
