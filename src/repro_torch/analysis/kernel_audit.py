"""Kernel and dispatch auditor of the port: the counterpart of the JAX
package's ``repro.analysis.kernel_audit``.

The JAX auditor traces jaxprs.  This one *runs* each target on small inputs
on a given device (the CPU takes the wrappers' plain versions, a card their
kernels) under a ``TorchDispatchMode`` that records every aten op's output
dtypes and every op that writes into a tensor sharing storage with one of
the target's arguments.  The kernels themselves are ``ctypes`` launches
(:func:`repro_torch.kernels.launch`) that no dispatch mode sees, so the
auditor also patches each wrapper module's ``launch`` and plain versions
(``*_ref``) for the run, to record what a kernel is handed, and compares
each argument's bytes before and after the call.

Rules, with the JAX catalog's ids and severities where the meaning carries
over (:mod:`repro_torch.analysis`):

``audit.trace`` (ERROR)
    A registered target failed to run: it would drop out of every rule.
``audit.dtype64`` (ERROR / NOTE)
    ERROR for a 64-bit tensor a target returns or hands to a kernel (a
    launch on the card, the plain version on the CPU), and for a 64-bit
    float anywhere; NOTE, naming the ops, for the int64 intermediates torch
    forces (``argmin``, ``nonzero``, the index copies of gathers and
    scatters).
``audit.dtype64-source`` (ERROR)
    ``torch.int64`` / ``torch.long`` / ``.long()`` / ``.double()`` /
    ``np.int64`` / ``np.float64`` (any attribute named for a 64-bit dtype)
    in the hot-path modules' ASTs.
``audit.host-sync`` (ERROR)
    ``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``.synchronize()`` / ``np.asarray`` / ``np.array`` inside a loop of the
    checkout hot path: one blocking device-to-host sync a leaf.
``audit.shape-bucket`` (ERROR)
    The bucket functions cover, quantize, are idempotent and monotone; and
    sizes of one bucket hand the kernels the same shapes and dtypes.
``audit.arg-write`` (ERROR)
    A target wrote into its argument (an op on the argument's storage, or
    its bytes changed across the call).  It replaces the JAX auditor's
    ``audit.io-alias``: the port's kernels take no aliasing hint, and its
    wrappers promise not to write their arguments, but for the solver loops
    ``prim_loop`` / ``mp_loop``, whose contract is an in-place update of the
    solver's own loop buffers (NOTE, with that reason).
"""

from __future__ import annotations

import ast
import collections
import contextlib
import ctypes
import dataclasses
import importlib
import inspect
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import resolve_device
from .findings import Finding, Report, Severity

#: 64-bit dtypes (int64 is torch's index dtype)
WIDE = (torch.int64, torch.uint64, torch.float64, torch.complex128)
#: attribute names that spell a 64-bit dtype in the source
_BAD64_ATTRS = ("int64", "uint64", "long", "float64", "double", "complex128")

_ARG_WRITE_REASON = (
    "the solver loops' contract is an in-place update of the solver's own "
    "loop buffers (best/bp/in_tree, l/d/p/in_tree), which the caller made "
    "for the call"
)

#: {rule: {subject prefix: reason}} — matches are downgraded to NOTE
ALLOWLIST: Dict[str, Dict[str, str]] = {
    "audit.dtype64-source": {
        "repro_torch.kernels.block_diff": (
            "hash_coefficients builds its table with host-side NumPy int64 "
            "RNG draws and bit-casts to int32 before any device upload; no "
            "64-bit value reaches a tensor (the runtime rule confirms)"
        ),
    },
    "audit.arg-write": {
        "kernels.segment_ops.prim_loop": _ARG_WRITE_REASON,
        "kernels.segment_ops.mp_loop": _ARG_WRITE_REASON,
    },
}

#: the wrapper modules whose ``launch`` and plain versions the run records
WRAPPER_MODULES = ("block_diff", "xor_delta", "sparse_apply", "chain_apply",
                   "segment_ops", "flash_attention")


# ------------------------------------------------------------------ targets
@dataclasses.dataclass(frozen=True)
class AuditTarget:
    """One entry point: ``build(device)`` returns ``(fn, args)`` such that
    ``fn(*args)`` runs the production dispatch on ``device``."""

    name: str
    build: Callable[[torch.device], Tuple[Callable, Tuple[Any, ...]]]
    description: str = ""


def _blocks(g: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randint(-2**31, 2**31 - 1, tuple(shape) + (8, 128), generator=g,
                         dtype=torch.int32).to(device)


def _rows(g: torch.Generator, n: int, count: int, device) -> torch.Tensor:
    return torch.randperm(n, generator=g)[:count].to(torch.int32).to(device)


def _instance(n: int = 12):
    """A small version graph: the root materialises every version, each
    version deltas from its predecessor, and a few skips."""
    from ..core.edge_arrays import EdgeArrays

    v = np.arange(1, n + 1)
    src = np.concatenate([np.zeros(n, np.int64), v[:-1], v[:-3]])
    dst = np.concatenate([v, v[1:], v[3:]])
    rng = np.random.RandomState(0)
    delta = np.concatenate([np.full(n, 1000.0), rng.uniform(10, 100, 2 * n - 4)])
    phi = np.concatenate([np.full(n, 50.0), rng.uniform(5, 40, 2 * n - 4)])
    return EdgeArrays.from_edges(n, src, dst, delta, phi)


def _kernel_targets() -> List[AuditTarget]:
    from ..core.solvers import torch_backend as tb
    from ..kernels import (
        block_diff,
        chain_apply,
        flash_attention,
        ops,
        segment_ops,
        sparse_apply,
        xor_delta,
    )

    nb = 64

    def built(fn):
        """``fn(g, dev) -> (fn, args)`` with a seeded generator."""
        return lambda dev: fn(torch.Generator().manual_seed(0), dev)

    def t(name, build, description=""):
        return AuditTarget(name, built(build), description)

    def rows(g, dev, shape):
        return torch.randn(shape, generator=g).to(dev)

    def attention(g, dev):
        q, k, v = (torch.randn((1, 128, h, 64), generator=g).to(torch.bfloat16).to(dev)
                   for h in (2, 1, 1))
        return lambda q, k, v: flash_attention.flash_attention(q, k, v, causal=True), (q, k, v)

    def loop_state(state, g, dev):
        ea = _instance()
        if state is tb.prim_state:
            return (*state(ea, dev), ea.n)
        return (*state(ea, 80.0, dev), ea.n)

    return [
        t("kernels.segment_ops.segment_min_rows",
          lambda g, dev: (segment_ops.segment_min_rows, (rows(g, dev, (256, 128)),)),
          "per-row min reduction (SSSP relaxation)"),
        t("kernels.segment_ops.segment_argmin_rows",
          lambda g, dev: (segment_ops.segment_argmin_rows, (rows(g, dev, (256, 128)),)),
          "per-row first-argmin (parent selection)"),
        t("kernels.segment_ops.min_argmin_1d",
          lambda g, dev: (segment_ops.min_argmin_1d, (rows(g, dev, (1000,)),)),
          "global (min, argmin) vertex pick"),
        t("kernels.segment_ops.prim_loop",
          lambda g, dev: (segment_ops.prim_loop, loop_state(tb.prim_state, g, dev)),
          "Prim's whole step loop, one launch"),
        t("kernels.segment_ops.mp_loop",
          lambda g, dev: (segment_ops.mp_loop, loop_state(tb.mp_state, g, dev)),
          "Modified Prim's whole step loop, one launch"),
        t("kernels.xor_delta.xor_delta",
          lambda g, dev: (xor_delta.xor_delta, (_blocks(g, (nb,), dev), _blocks(g, (nb,), dev))),
          "XOR delta encode/apply"),
        t("kernels.block_diff.changed_block_mask",
          lambda g, dev: (block_diff.changed_block_mask,
                          (_blocks(g, (nb,), dev), _blocks(g, (nb,), dev))),
          "changed-block detection (delta encoder)"),
        t("kernels.block_diff.block_hash",
          lambda g, dev: (block_diff.block_hash, (
              _blocks(g, (nb,), dev),
              torch.from_numpy(block_diff.hash_coefficients()).to(dev))),
          "per-block content hash (dedup hints)"),
        t("kernels.sparse_apply.sparse_delta_apply",
          lambda g, dev: (sparse_apply.sparse_delta_apply, (
              _blocks(g, (nb,), dev), _blocks(g, (16,), dev), _rows(g, nb, 16, dev))),
          "block-sparse delta apply (one-hop recreation)"),
        t("kernels.chain_apply.chain_delta_apply",
          lambda g, dev: (chain_apply.chain_delta_apply, (
              _blocks(g, (nb,), dev), _blocks(g, (4, 16), dev),
              torch.stack([_rows(g, nb, 16, dev) for _ in range(4)]))),
          "fused K-step chain apply (whole-chain checkout)"),
        t("kernels.chain_apply.chain_delta_apply_batched",
          lambda g, dev: (chain_apply.chain_delta_apply_batched, (
              _blocks(g, (4, nb), dev), _blocks(g, (4, 16), dev),
              torch.stack([_rows(g, nb, 16, dev) for _ in range(4)]))),
          "batched fused chain apply (many leaves, one launch)"),
        t("kernels.ops._compact",
          lambda g, dev: (lambda m, b: ops._compact(m, b, capacity=16), (
              (torch.rand((nb, 1), generator=g) < 0.2).to(torch.int32).to(dev),
              _blocks(g, (nb,), dev))),
          "changed-block compaction (sparse encode)"),
        t("kernels.ops.to_blocks",
          lambda g, dev: (lambda x: ops.to_blocks(x)[0], (rows(g, dev, (4096,)),)),
          "byte-preserving layout conversion (encode side)"),
        t("kernels.flash_attention.flash_attention", attention,
          "prefill attention (causal, GQA)"),
    ]


def _solver_targets() -> List[AuditTarget]:
    from ..core.solvers import torch_backend as tb

    def lmg(dev):
        ea = _instance()
        nv = ea.n + 1
        scorer = tb.LmgScorer(ea.src.astype(np.int32), ea.dst.astype(np.int32),
                              ea.delta.astype(np.float32), ea.phi.astype(np.float32),
                              device=dev)
        tree = np.zeros(nv, np.float32)
        args = (np.ones(ea.m, bool), tree, tree + 50.0, np.ones(nv, np.float32),
                np.arange(nv, dtype=np.int32), np.ones(nv, np.int32), 12000.0, 20000.0)
        return scorer.score, args

    return [
        AuditTarget("core.solvers.torch_backend.sssp",
                    lambda dev: (lambda ea: tb.sssp(ea, device=dev), (_instance(),)),
                    "Bellman-Ford SSSP (Problem 2 / SPT)"),
        AuditTarget("core.solvers.torch_backend.prim",
                    lambda dev: (lambda ea: tb.prim(ea, device=dev), (_instance(),)),
                    "Prim (Problem 1, undirected)"),
        AuditTarget("core.solvers.torch_backend.modified_prim_core",
                    lambda dev: (lambda ea: tb.modified_prim_core(ea, 80.0, device=dev),
                                 (_instance(),)),
                    "Modified Prim (Problems 4/6)"),
        AuditTarget("core.solvers.torch_backend.LmgScorer.score", lmg,
                    "LMG candidate scoring round (Problems 3/5)"),
    ]


def audit_targets() -> List[AuditTarget]:
    """Every registered kernel wrapper and solver entry point, in audit order."""
    return _kernel_targets() + _solver_targets()


# ---------------------------------------------------------------- recording
def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    """The tensors in a (nested) argument or result."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            yield from _tensors(x)
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class RunRecord(TorchDispatchMode):
    """What one run of a target did: the 64-bit outputs of its aten ops, the
    ops that wrote into an argument's storage, and what each kernel entry (a
    ``launch`` or a plain version) was handed."""

    def __init__(self, args: Sequence[Any] = ()):
        super().__init__()
        self.arg_storages = {}
        for i, t in enumerate(_tensors(list(args))):
            if _storage(t):
                self.arg_storages.setdefault(_storage(t), i)
        self.wide: collections.Counter = collections.Counter()  # "op:dtype" -> n
        self.writes: List[Tuple[str, int]] = []                 # (op, argument)
        self.entries: List[Tuple[str, tuple]] = []              # (entry, signature)
        self.entry64: List[str] = []                            # "entry:dtype"
        self._ptrs: Dict[int, Tuple[str, tuple]] = {}           # data_ptr -> (dtype, shape)
        for t in _tensors(list(args)):
            self._see(t)

    def _see(self, t: torch.Tensor) -> None:
        """Name the address ``t`` starts at by its dtype and shape (the
        latest allocation there: the caching allocator reuses addresses)."""
        if t.data_ptr():
            self._ptrs[t.data_ptr()] = (str(t.dtype), tuple(t.shape))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func).removeprefix("aten.")
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            val = kwargs.get(a.name) if (a.kwarg_only or a.name in kwargs) else (
                args[i] if i < len(args) else None)
            for t in _tensors(val):
                arg = self.arg_storages.get(_storage(t))
                if arg is not None:
                    self.writes.append((name, arg))
        out = func(*args, **kwargs)
        # a view or an in-place result starts where its base does: the
        # address keeps naming the allocation
        fresh = not any(r.alias_info is not None for r in func._schema.returns)
        for t in _tensors(out):
            if fresh:
                self._see(t)
            if t.dtype in WIDE:
                self.wide[f"{name}:{t.dtype}".replace("torch.", "")] += 1
        return out

    def _signature(self, entry: str, values: Sequence[Any]) -> tuple:
        sig = []
        for v in values:
            if isinstance(v, torch.Tensor):
                dtype, shape = str(v.dtype), tuple(v.shape)
            elif isinstance(v, bool) or not isinstance(v, int):
                sig.append(type(v).__name__ if isinstance(v, ctypes._SimpleCData) else repr(v))
                continue
            elif v in self._ptrs:
                dtype, shape = self._ptrs[v]
            elif v >= 1 << 40:  # a device address of a tensor made outside the run
                sig.append("pointer")
                continue
            else:
                sig.append(v)
                continue
            sig.append((dtype, shape))
            if dtype in map(str, WIDE):
                self.entry64.append(f"{entry}:{dtype.removeprefix('torch.')}")
        return tuple(sig)

    def entry(self, name: str, fn: Callable) -> Callable:
        """``fn`` (a wrapper module's ``launch`` or plain version), recording
        what it is handed."""
        def recorded(*args, **kwargs):
            if name == "launch":
                entry, values = args[0], args[2:]
            else:
                entry, values = name, list(args) + list(kwargs.values())
            self.entries.append((entry, self._signature(entry, values)))
            return fn(*args, **kwargs)
        return recorded


@contextlib.contextmanager
def recording(record: RunRecord) -> Iterator[RunRecord]:
    """Run under ``record``: its dispatch mode, and each wrapper module's
    ``launch`` and plain versions patched to record their arguments."""
    patches = []
    for stem in WRAPPER_MODULES:
        mod = importlib.import_module(f"repro_torch.kernels.{stem}")
        for name, fn in list(vars(mod).items()):
            if name == "launch" or (name.endswith("_ref") and callable(fn)):
                patches.append((mod, name, fn))
    for mod, name, fn in patches:
        setattr(mod, name, record.entry(name, fn))
    try:
        with record:
            yield record
    finally:
        for mod, name, fn in patches:
            setattr(mod, name, fn)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().reshape(-1).view(torch.uint8).clone()


@dataclasses.dataclass
class TargetRun:
    """One run of a target: its record, its result, and the arguments
    (by position among the tensors) whose bytes changed across the call."""

    record: RunRecord
    result: Any
    changed_args: List[int]


def run_target(target: AuditTarget, device) -> TargetRun:
    """Build ``target``'s inputs on ``device`` and run it under a record."""
    fn, args = target.build(torch.device(device))
    tensors = list(_tensors(list(args)))
    before = [_bytes(t) for t in tensors]
    record = RunRecord(args)
    with recording(record):
        result = fn(*args)
    changed = [i for i, (t, b) in enumerate(zip(tensors, before))
               if not torch.equal(_bytes(t), b)]
    return TargetRun(record, result, changed)


def _allowlisted(rule: str, subject: str) -> Optional[str]:
    for prefix, reason in ALLOWLIST.get(rule, {}).items():
        if subject.startswith(prefix):
            return reason
    return None


def _emit(report: Report, rule: str, severity: Severity, subject: str,
          message: str, fix_hint: str = "") -> None:
    """Add a finding, downgrading allowlisted subjects to NOTE."""
    reason = _allowlisted(rule, subject)
    if reason is not None:
        severity = Severity.NOTE
        message = f"{message} [allowlisted: {reason}]"
    report.add(Finding(rule, severity, subject, message, fix_hint))


# ------------------------------------------------------- rule: audit.dtype64
def check_dtype64(report: Report, target: AuditTarget, run: TargetRun) -> None:
    """No 64-bit tensor returned or handed to a kernel, no 64-bit float
    anywhere; the int64 intermediates torch forces are NOTEs."""
    report.bump("audit.dtype64")
    hard = collections.Counter(
        f"returned:{t.dtype}".replace("torch.", "")
        for t in _tensors(run.result) if t.dtype in WIDE)
    hard.update(run.record.entry64)
    forced = collections.Counter()
    for key, n in run.record.wide.items():
        (forced if key.endswith(("int64", "uint64")) else hard)[key] += n
    if hard:
        detail = ", ".join(f"{k} x{n}" for k, n in sorted(hard.items()))
        _emit(report, "audit.dtype64", Severity.ERROR, target.name,
              f"64-bit values returned, handed to a kernel or computed: {detail}",
              "narrow to int32 / float32 (.to(torch.int32), dtype=torch.int32 "
              "in reductions and factories) before the value leaves the "
              "target or reaches a launch")
    elif forced:
        detail = ", ".join(f"{k} x{n}" for k, n in sorted(forced.items()))
        _emit(report, "audit.dtype64", Severity.NOTE, target.name,
              f"int64 intermediates torch forces (index dtype), narrowed "
              f"before they leave: {detail}")


# ------------------------------------------------ rule: audit.dtype64-source
#: the hot-path modules scanned for 64-bit dtype tokens (AST attributes, so
#: docstrings and comments do not count)
DTYPE_SOURCE_MODULES = (
    "repro_torch.kernels.segment_ops",
    "repro_torch.kernels.ops",
    "repro_torch.kernels.chain_apply",
    "repro_torch.kernels.sparse_apply",
    "repro_torch.kernels.block_diff",
    "repro_torch.kernels.xor_delta",
    "repro_torch.store.delta",
    "repro_torch.store.materializer",
    "repro_torch.core.solvers.torch_backend",
)


def _module_tree(module_name: str) -> ast.Module:
    return ast.parse(inspect.getsource(importlib.import_module(module_name)))


def check_dtype64_source(report: Report, module_name: str) -> None:
    """No attribute named for a 64-bit dtype (``torch.int64``,
    ``torch.long``, ``.long()``, ``.double()``, ``np.int64``,
    ``np.float64``, ...) in the module."""
    report.bump("audit.dtype64-source")
    lines = sorted({node.lineno for node in ast.walk(_module_tree(module_name))
                    if isinstance(node, ast.Attribute) and node.attr in _BAD64_ATTRS})
    if lines:
        _emit(report, "audit.dtype64-source", Severity.ERROR, module_name,
              f"{len(lines)} line(s) name a 64-bit dtype: {lines}",
              "compute in 32-bit; where torch wants an int64 index, keep the "
              "copy local to the gather or scatter")


# ---------------------------------------------------- rule: audit.host-sync
#: {module: function qualnames} forming the checkout hot path; a
#: device-to-host call *inside a loop* there syncs once a leaf
HOT_PATH_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "repro_torch.store.delta": ("apply_delta", "apply_delta_chains"),
    "repro_torch.store.materializer": (
        "Materializer._execute_stepwise",
        "Materializer._execute_fused",
        "Materializer._materialize_chain",
    ),
}

_SYNC_ATTRS = ("item", "tolist", "cpu", "numpy", "synchronize")
_NP_SYNC_FUNCS = ("asarray", "array")


def _qualnames(tree: ast.Module):
    """Yield (qualname, FunctionDef) for every function, class-aware."""
    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from walk(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")
    yield from walk(tree, "")


def _sync_calls_in_loops(fn: ast.AST) -> List[Tuple[int, str]]:
    """(line, callname) of device-to-host syncs inside for/while loops."""
    hits: List[Tuple[int, str]] = []

    def scan(node, in_loop):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # a nested function is its own scope
            entering = in_loop or isinstance(child, (ast.For, ast.While))
            if isinstance(child, ast.Call) and in_loop and isinstance(child.func, ast.Attribute):
                f, base = child.func, child.func.value
                if (f.attr in _NP_SYNC_FUNCS and isinstance(base, ast.Name)
                        and base.id in ("np", "numpy")):
                    hits.append((child.lineno, f"np.{f.attr}"))
                elif f.attr in _SYNC_ATTRS:
                    hits.append((child.lineno, f".{f.attr}"))
            scan(child, entering)

    scan(fn, False)
    return hits


def check_host_sync(report: Report, module_name: str, functions: Sequence[str]) -> None:
    """No device-to-host sync a leaf in the checkout hot path.  Syntactic
    by design: the listed functions handle device-resident leaves, where
    each such call blocks on the stream; collect the results and bring them
    over once after the loop (``store.delta._to_host``)."""
    found = dict(_qualnames(_module_tree(module_name)))
    for qual in functions:
        report.bump("audit.host-sync")
        fn = found.get(qual)
        subject = f"{module_name}.{qual}"
        if fn is None:
            _emit(report, "audit.host-sync", Severity.WARNING, subject,
                  "hot-path function missing from module (rule config is stale)",
                  "update HOT_PATH_FUNCTIONS in repro_torch/analysis/kernel_audit.py")
            continue
        hits = _sync_calls_in_loops(fn)
        if hits:
            detail = ", ".join(f"{name}@L{line}" for line, name in hits)
            _emit(report, "audit.host-sync", Severity.ERROR, subject,
                  f"device-to-host sync inside a per-leaf loop: {detail}",
                  "queue the device results and copy them to the host once "
                  "after the loop (store.delta._to_host)")


# -------------------------------------------------- rule: audit.shape-bucket
@dataclasses.dataclass(frozen=True)
class BucketContract:
    """A size-bucketing function and the contract its callers rely on."""

    name: str
    fn: Callable[[int], int]
    kind: str                  # "pow2" | "mult8"
    max_check: int = 4096


def bucket_contracts() -> List[BucketContract]:
    from ..core.solvers import torch_backend as tb
    from ..kernels import ops
    from ..store import delta

    return [
        BucketContract("store.delta._slot_bucket", delta._slot_bucket, "pow2"),
        BucketContract("kernels.ops._round_capacity", ops._round_capacity, "pow2"),
        BucketContract("core.solvers.torch_backend._bucket_rows", tb._bucket_rows, "pow2"),
        BucketContract("core.solvers.torch_backend._bucket_width", tb._bucket_width,
                       "mult8"),
    ]


def check_bucket_contract(report: Report, c: BucketContract) -> None:
    """Bucket functions must cover (f(k) >= k), quantize (pow2 /
    mult-of-8), be idempotent (f(f(k)) == f(k)) and monotone: then the
    shapes the kernels see stay O(log max_size) in number."""
    report.bump("audit.shape-bucket")
    problems: List[str] = []
    prev = 0
    for k in range(1, c.max_check + 1):
        b = c.fn(k)
        if b < k:
            problems.append(f"f({k})={b} < k (dropped data)")
        if c.kind == "pow2" and b & (b - 1):
            problems.append(f"f({k})={b} not a power of two")
        if c.kind == "mult8" and b % 8:
            problems.append(f"f({k})={b} not a multiple of 8")
        if c.fn(b) != b:
            problems.append(f"f(f({k}))={c.fn(b)} != f({k})={b} (not idempotent)")
        if b < prev:
            problems.append(f"f({k})={b} < f({k - 1})={prev} (not monotone)")
        prev = b
        if len(problems) >= 4:
            break
    if problems:
        _emit(report, "audit.shape-bucket", Severity.ERROR, c.name,
              f"bucket contract violated: {'; '.join(problems[:4])}",
              "restore the pow2 / mult8 rounding: otherwise every size hands "
              "the kernels a new shape (or data is dropped)")


@dataclasses.dataclass(frozen=True)
class BucketProbe:
    """Sizes of one bucket must hand the kernels the same shapes and dtypes."""

    name: str
    run: Callable[[int, torch.device], Any]   # (size, device) -> runs the path
    sizes: Tuple[int, ...]                      # all mapping to one bucket


def signature(size: int, probe: BucketProbe, device) -> str:
    """What the kernel entries were handed when ``probe`` ran at ``size``."""
    record = RunRecord()
    with recording(record):
        probe.run(size, torch.device(device))
    return ";".join(f"{entry}{sig}" for entry, sig in record.entries)


def bucket_probes() -> List[BucketProbe]:
    from ..core.solvers import torch_backend as tb
    from ..kernels import ops
    from ..store import delta

    def lmg(nc: int, dev) -> None:
        rng = np.random.RandomState(nc)
        nv = 16
        cu, cv = (rng.randint(0, nv, nc).astype(np.int32) for _ in range(2))
        scorer = tb.LmgScorer(cu, cv, rng.uniform(1, 9, nc).astype(np.float32),
                              rng.uniform(1, 9, nc).astype(np.float32), device=dev)
        z = np.zeros(nv, np.float32)
        scorer.score(np.ones(nc, bool), z, z, z + 1, np.arange(nv, dtype=np.int32),
                     np.ones(nv, np.int32), 0.0, 100.0)

    def sparse(n_changed: int, dev) -> None:
        g = torch.Generator().manual_seed(n_changed)
        base = _blocks(g, (64,), dev)
        new = base.clone()
        new[:n_changed] += 1
        idx, packed, _ = ops.sparse_encode(base, new)
        ops.sparse_apply(base, packed, idx)

    def chain(total_slots: int, dev) -> None:
        g = torch.Generator().manual_seed(total_slots)
        cap = delta._slot_bucket(total_slots)
        idx = torch.full((cap,), -1, dtype=torch.int32)
        idx[:total_slots] = torch.arange(total_slots, dtype=torch.int32)
        ops.chain_apply(_blocks(g, (8,), dev), _blocks(g, (cap,), dev), idx.to(dev))

    return [
        BucketProbe("core.solvers.torch_backend.LmgScorer/_bucket_rows", lmg, (65, 100, 128)),
        BucketProbe("kernels.ops.sparse_encode/_round_capacity", sparse, (5, 6, 8)),
        BucketProbe("store.delta.apply_delta_chains/_slot_bucket", chain, (3, 5, 8)),
    ]


def check_bucket_probe(report: Report, p: BucketProbe, device) -> None:
    report.bump("audit.shape-bucket")
    sigs: Dict[str, List[int]] = {}
    for n in p.sizes:
        sigs.setdefault(signature(n, p, device), []).append(n)
    if len(sigs) > 1:
        detail = "; ".join(f"sizes {v} -> {k[:120]}" for k, v in sigs.items())
        _emit(report, "audit.shape-bucket", Severity.ERROR, p.name,
              f"same-bucket sizes hand the kernels different shapes: {detail}",
              "route the size through the bucket function before shaping the "
              "tensors a kernel is handed")


# ----------------------------------------------------- rule: audit.arg-write
def check_arg_write(report: Report, target: AuditTarget, run: TargetRun) -> None:
    """No target writes into its argument: no op on an argument's storage,
    and every argument's bytes the same after the call (a launch writes
    where no dispatch mode sees it)."""
    report.bump("audit.arg-write")
    ops = sorted({f"{op} on argument {i}" for op, i in run.record.writes})
    changed = [f"argument {i}'s bytes changed" for i in run.changed_args]
    if ops or changed:
        _emit(report, "audit.arg-write", Severity.ERROR, target.name,
              f"writes into its argument: {', '.join(ops + changed)}",
              "write into a new tensor (torch.empty / clone) and return it")


# ------------------------------------------------------------------- driver
def run_audit(device="cuda") -> Report:
    """Run the whole rule catalog on ``device`` (the kernels on a card, the
    plain versions on the CPU); returns a :class:`Report`.  A target that
    fails to run is a finding too (``audit.trace``)."""
    device = resolve_device(device)
    report = Report(tool="audit")
    for target in audit_targets():
        report.bump("audit.trace")
        try:
            run = run_target(target, device)
        except Exception as e:
            report.add(Finding(
                "audit.trace", Severity.ERROR, target.name,
                f"run on {device} failed: {type(e).__name__}: {e}",
                "fix the target or its registry entry in "
                "repro_torch/analysis/kernel_audit.py",
            ))
            continue
        check_dtype64(report, target, run)
        check_arg_write(report, target, run)
    for module in DTYPE_SOURCE_MODULES:
        check_dtype64_source(report, module)
    for module, functions in HOT_PATH_FUNCTIONS.items():
        check_host_sync(report, module, functions)
    for contract in bucket_contracts():
        check_bucket_contract(report, contract)
    for probe in bucket_probes():
        check_bucket_probe(report, probe, device)
    return report
