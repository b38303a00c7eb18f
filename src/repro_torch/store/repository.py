"""Repository — named refs over the VersionStore (the DataHub-style surface).

The :class:`~repro_torch.store.version_store.VersionStore` speaks raw integer
version ids; this facade gives it **branches** (mutable named pointers that
advance on commit), **tags** (immutable named pointers), and a git-shaped
verb set —

* ``commit(tree, parent=ref)`` — add a version, advancing the target branch;
* ``branch(name, at=ref)`` / ``tag(name, at=ref)`` / ``switch(name)``;
* ``checkout(ref)`` / ``checkout_many(refs)`` — recreation through the
  materialization layer; ``checkout(ref)`` is byte-identical to
  ``checkout(vid)``;
* ``log(ref)`` — ancestry walk over the derivation DAG, newest first;
* ``diff(a, b)`` — leaf-level tree diff (added / removed / changed tensors);
* ``repack(spec)`` / ``gc()`` — re-optimize physical storage and drop
  orphaned objects.
* ``fsck()`` — integrity-check the storage graph, objects and refs;
* ``serve(...)`` — an asyncio :class:`~repro_torch.service.DatasetService`
  over the repository.

Refs persist in the store's ``meta.msgpack`` next to the version metadata,
in the JAX package's format, so branches and tags survive a close/reopen and
are visible to either package.  Every ref accepts either a name or a raw vid.
The store runs on the card unless ``device="cpu"`` is passed through.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import OptimizeSpec
from .delta import FlatTree
from .version_store import VersionMeta, VersionStore

__all__ = ["Repository", "TreeDiff", "Ref"]

#: a ref: branch name, tag name, or raw version id
Ref = Union[str, int]


@dataclasses.dataclass(frozen=True)
class TreeDiff:
    """Leaf-level diff between two checked-out trees."""

    a: int                      # resolved vids
    b: int
    added: tuple                # leaf keys present only in b
    removed: tuple              # leaf keys present only in a
    changed: tuple              # leaf keys whose tensor content differs
    unchanged: int              # identical leaves
    bytes_added: int            # Σ nbytes over added leaves
    bytes_removed: int          # Σ nbytes over removed leaves
    bytes_changed: int          # Σ nbytes over changed leaves (b side)

    def summary(self) -> str:
        return (
            f"v{self.a}..v{self.b}: +{len(self.added)} -{len(self.removed)} "
            f"~{len(self.changed)} leaves ({self.bytes_changed/1e6:.2f} MB "
            f"changed), {self.unchanged} unchanged"
        )


def _same_bytes(x: torch.Tensor, y: torch.Tensor) -> bool:
    """Byte-level equality: NaN-safe and dtype-exact."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    return torch.equal(
        x.contiguous().reshape(-1).view(torch.uint8),
        y.contiguous().reshape(-1).view(torch.uint8),
    )


class Repository:
    """Named-ref facade over a :class:`VersionStore`.

    The current branch (``head``) starts as ``"main"``; the first commit
    creates it.  All state changes (commit / branch / tag / switch) persist
    immediately.
    """

    def __init__(
        self,
        root: Union[str, Path, None] = None,
        *,
        store: Optional[VersionStore] = None,
        **store_kwargs: Any,
    ) -> None:
        if (root is None) == (store is None):
            raise ValueError("pass exactly one of root / store")
        self.store = store or VersionStore(root, **store_kwargs)

    # ------------------------------------------------------------------ refs
    @property
    def head(self) -> str:
        """The current branch name (commits without ``branch=`` advance it)."""
        return self.store.refs["head"]

    def branches(self) -> Dict[str, int]:
        return dict(self.store.refs["branches"])

    def tags(self) -> Dict[str, int]:
        return dict(self.store.refs["tags"])

    def resolve(self, ref: Optional[Ref] = None) -> int:
        """Ref -> vid.  ``None`` resolves the current branch tip; branch
        names shadow tag names; raw vids pass through (validated).  Takes
        the store lock, so the snapshot point is a before- or after-commit
        tip."""
        with self.store._lock:
            if ref is None:
                ref = self.head
            if isinstance(ref, (int, np.integer)):
                vid = int(ref)
                if vid not in self.store.versions:
                    raise ValueError(f"unknown version id {vid}")
                return vid
            branches = self.store.refs["branches"]
            tags = self.store.refs["tags"]
            if ref in branches:
                return branches[ref]
            if ref in tags:
                return tags[ref]
            raise ValueError(
                f"unknown ref {ref!r}: branches={sorted(branches)}, "
                f"tags={sorted(tags)}"
            )

    def branch(self, name: str, at: Optional[Ref] = None) -> str:
        """Create branch ``name`` at ``at`` (default: current head tip)."""
        self._check_ref_name(name)
        if name in self.store.refs["branches"]:
            raise ValueError(f"branch {name!r} already exists")
        self.store.refs["branches"][name] = self.resolve(at)
        self.store.save_refs()
        return name

    def tag(self, name: str, at: Optional[Ref] = None) -> str:
        """Create immutable tag ``name`` at ``at`` (default: head tip)."""
        self._check_ref_name(name)
        if name in self.store.refs["tags"]:
            raise ValueError(f"tag {name!r} already exists (tags are immutable)")
        self.store.refs["tags"][name] = self.resolve(at)
        self.store.save_refs()
        return name

    def switch(self, branch: str) -> int:
        """Make ``branch`` the current head; returns its tip vid."""
        if branch not in self.store.refs["branches"]:
            raise ValueError(
                f"unknown branch {branch!r}: {sorted(self.store.refs['branches'])}"
            )
        self.store.refs["head"] = branch
        self.store.save_refs()
        return self.store.refs["branches"][branch]

    def _check_ref_name(self, name: str) -> None:
        if not isinstance(name, str) or not name or name.isdigit():
            raise ValueError(
                f"ref names must be non-numeric non-empty strings, got {name!r}"
            )

    # --------------------------------------------------------------- commits
    def commit(
        self,
        tree: Any,
        *,
        message: str = "",
        parent: Union[Ref, Sequence[Ref], None] = None,
        branch: Optional[str] = None,
    ) -> int:
        """Commit a payload, advancing ``branch`` (default: current head).

        ``parent`` defaults to the branch tip; pass a ref for an explicit
        base or a sequence of refs for a merge commit.  Committing to a
        branch that does not exist yet is allowed only for the very first
        commit of an empty store or with an explicit ``parent`` (creating
        the branch there, like ``git checkout -b``) — otherwise a typo'd
        branch name would silently create an orphan lineage.
        """
        branch = branch if branch is not None else self.head
        self._check_ref_name(branch)
        if parent is None:
            tip = self.store.refs["branches"].get(branch)
            if tip is not None:
                parents = [tip]
            elif not self.store.versions:
                parents = []  # initial commit of an empty store
            else:
                raise ValueError(
                    f"branch {branch!r} does not exist but the store has "
                    f"{len(self.store.versions)} versions; create the branch "
                    f"first (branch()) or pass parent= explicitly — an "
                    f"implicit parentless commit would orphan the new version"
                )
        elif isinstance(parent, (str, int, np.integer)):
            parents = [self.resolve(parent)]
        else:
            parents = [self.resolve(p) for p in parent]
        # the branch ref advances inside the commit's own metadata write
        return self.store.commit(
            tree, parents=parents, message=message, update_branch=branch
        )

    # -------------------------------------------------------------- checkout
    def checkout(self, ref: Optional[Ref] = None) -> FlatTree:
        """Recreate the tree at ``ref`` (default: head tip).  Identical to
        ``VersionStore.checkout(resolve(ref))`` — same plan, same cache."""
        return self.store.checkout(self.resolve(ref))

    def checkout_many(self, refs: Sequence[Ref]) -> List[FlatTree]:
        """Batch checkout: one decode plan over all resolved vids."""
        return self.store.checkout_many([self.resolve(r) for r in refs])

    # ------------------------------------------------------------- inspect
    def log(self, ref: Optional[Ref] = None) -> List[VersionMeta]:
        """Ancestry of ``ref`` over the derivation DAG, newest-vid first."""
        seen = set()
        frontier = [self.resolve(ref)]
        while frontier:
            v = frontier.pop()
            if v in seen:
                continue
            seen.add(v)
            frontier.extend(self.store.versions[v].parents)
        return [self.store.versions[v] for v in sorted(seen, reverse=True)]

    def diff(self, a: Ref, b: Ref) -> TreeDiff:
        """Leaf-level diff of the trees at two refs."""
        va, vb = self.resolve(a), self.resolve(b)
        # read-only: the trees may be the cache's own, so nothing is copied
        ta, tb = self.store._counted_checkout(
            [va, vb], self.store.materializer.checkout_shared
        )
        added = tuple(sorted(set(tb) - set(ta)))
        removed = tuple(sorted(set(ta) - set(tb)))
        changed, unchanged = [], 0
        for k in sorted(set(ta) & set(tb)):
            if _same_bytes(ta[k], tb[k]):
                unchanged += 1
            else:
                changed.append(k)
        return TreeDiff(
            a=va, b=vb,
            added=added, removed=removed, changed=tuple(changed),
            unchanged=unchanged,
            bytes_added=sum(tb[k].nbytes for k in added),
            bytes_removed=sum(ta[k].nbytes for k in removed),
            bytes_changed=sum(tb[k].nbytes for k in changed),
        )

    # --------------------------------------------------------------- storage
    def repack(
        self, spec: OptimizeSpec, *, use_access_frequencies: bool = False
    ) -> Dict[str, Any]:
        """Re-optimize physical storage against a declarative spec on the
        store's device (see ``VersionStore.repack``)."""
        return self.store.repack(
            spec, use_access_frequencies=use_access_frequencies)

    def fsck(self, **kwargs: Any):
        """Integrity-check the underlying store's storage graph, refs and
        recorded constraints; returns an analysis
        :class:`~repro_torch.analysis.findings.Report`."""
        return self.store.fsck(**kwargs)

    def serve(self, **kwargs: Any) -> Any:
        """Build a :class:`~repro_torch.service.DatasetService` over this repo.

        Keyword arguments pass through to ``DatasetService`` (reader-pool
        width, batching window, fsck cadence, ...); the caller starts it::

            async with repo.serve(readers=8) as svc:
                tree = await svc.checkout("main")
        """
        from ..service import DatasetService  # local: service imports us

        return DatasetService(self, **kwargs)

    def gc(self) -> int:
        return self.store.gc()

    def close(self) -> None:
        self.store.close()

    def __enter__(self) -> "Repository":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
