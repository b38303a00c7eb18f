"""The port's kernel auditor (``repro_torch.analysis.kernel_audit``) on the
CPU, mirroring the JAX auditor's tests (tests/test_analysis_audit.py):

* the whole catalog over the registered targets, through the CLI
  (``python -m repro_torch.analysis audit --device cpu``): no new finding
  against the committed ``analysis_baseline_torch.json``, exit 0, every
  target ran;
* each rule fires on a planted fault: a returned ``.to(torch.int64)``, an
  unnarrowed ``argmin``, an int64 tensor handed to a kernel, a sync in a
  loop, an identity or undersized bucket, an unbucketed probe, a wrapper
  that writes its argument through an op or behind the dispatcher's back
  (as a launch does), while ``prim_loop`` / ``mp_loop`` are NOTEs;
* importing the auditor and both CLIs leaves ``jax`` out of
  ``sys.modules`` (in a subprocess, as tests/test_torch_store.py checks).
"""

import ast
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import cli
from repro_torch.analysis import findings as F
from repro_torch.analysis import kernel_audit as KA
from repro_torch.kernels import segment_ops, sparse_apply

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def audit_json():
    """The CLI's JSON report and exit status on the CPU, against the
    committed baseline."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["audit", "--device", "cpu", "--json",
                       "--baseline", str(ROOT / cli.DEFAULT_BASELINE)])
    return rc, json.loads(out.getvalue())


def _target(fn, *args, name="test.target"):
    return KA.AuditTarget(name, lambda dev: (fn, args))


def _run(fn, *args, check=KA.check_dtype64):
    t = _target(fn, *args)
    r = F.Report(tool="audit")
    check(r, t, KA.run_target(t, CPU))
    return r


class TestFullAudit:
    def test_zero_new_findings_vs_committed_baseline(self, audit_json):
        rc, report = audit_json
        new = [f for f in report["findings"]
               if f["severity"] != "note" and not f["baselined"]]
        assert report["new"] == 0 and rc == 0, new

    def test_no_gating_finding_with_an_empty_baseline(self, audit_json):
        # the committed baseline accepts nothing: every finding is a NOTE
        baseline = json.loads((ROOT / cli.DEFAULT_BASELINE).read_text())
        assert baseline["findings"] == {}
        rc, report = audit_json
        gating = [f for f in report["findings"] if f["severity"] != "note"]
        assert rc == 0 and gating == []
        assert not [f for f in report["findings"] if f["baselined"]]

    def test_every_target_ran(self, audit_json):
        _, report = audit_json
        assert report["checked"]["audit.trace"] == len(KA.audit_targets())
        assert not [f for f in report["findings"] if f["rule"] == "audit.trace"]
        names = {t.name for t in KA.audit_targets()}
        assert {"kernels.flash_attention.flash_attention", "kernels.segment_ops.prim_loop",
                "kernels.segment_ops.mp_loop"} <= names

    def test_solver_loops_write_their_buffers_as_notes(self, audit_json):
        _, report = audit_json
        writes = {f["subject"]: f for f in report["findings"] if f["rule"] == "audit.arg-write"}
        assert set(writes) == {"kernels.segment_ops.prim_loop", "kernels.segment_ops.mp_loop"}
        assert all(f["severity"] == "note" and "allowlisted" in f["message"]
                   for f in writes.values())

    def test_no_returned_or_launched_64_bit_value(self, audit_json):
        _, report = audit_json
        errors = [f for f in report["findings"]
                  if f["rule"] == "audit.dtype64" and f["severity"] != "note"]
        assert errors == []


class TestDtype64Rule:
    def test_returned_int64_flags(self):
        (f,) = _run(lambda x: x.to(torch.int64), torch.arange(8, dtype=torch.int32)).findings
        assert f.severity == F.Severity.ERROR and "returned:int64" in f.message

    def test_int32_math_clean(self):
        r = _run(lambda x: (x + 1) * 2, torch.arange(8, dtype=torch.int32))
        assert r.findings == []

    def test_unnarrowed_argmin_flags(self):
        (f,) = _run(lambda x: torch.argmin(x), torch.randn(32)).findings
        assert f.severity == F.Severity.ERROR and "int64" in f.message

    def test_narrowed_argmin_is_a_note(self):
        (f,) = _run(lambda x: torch.argmin(x).to(torch.int32), torch.randn(32)).findings
        assert f.severity == F.Severity.NOTE and "argmin" in f.message

    def test_float64_intermediate_flags(self):
        (f,) = _run(lambda x: x.double().sum().float(), torch.randn(8)).findings
        assert f.severity == F.Severity.ERROR and "float64" in f.message

    def test_int64_handed_to_a_kernel_flags(self):
        base, blocks = torch.zeros((8, 8, 128), dtype=torch.int32), torch.ones(
            (2, 8, 128), dtype=torch.int32)
        idx = torch.tensor([1, 3])  # int64

        def wrapper(b, p, i):
            # calls the plain version as the module binds it: the entry the
            # run records, as a launch on the card
            return sparse_apply.sparse_delta_apply_ref(b, p, i).clone()

        (f,) = _run(wrapper, base, blocks, idx).findings
        assert f.severity == F.Severity.ERROR
        assert "sparse_delta_apply_ref:int64" in f.message


class TestHostSyncRule:
    def test_sync_in_loop_detected(self):
        src = (
            "def f(items):\n"
            "    out = []\n"
            "    for x in items:\n"
            "        out.append(np.asarray(x))\n"
            "        y = x.item()\n"
            "        z = x.cpu()\n"
            "        w = x.tolist()\n"
            "        torch.cuda.synchronize()\n"
            "    return out\n"
        )
        fn = ast.parse(src).body[0]
        names = {n for _, n in KA._sync_calls_in_loops(fn)}
        assert names == {"np.asarray", ".item", ".cpu", ".tolist", ".synchronize"}

    def test_sync_after_loop_clean(self):
        src = (
            "def f(items):\n"
            "    pending = []\n"
            "    for x in items:\n"
            "        pending.append(g(x))\n"
            "    return _to_host(pending)[0].numpy()\n"
        )
        fn = ast.parse(src).body[0]
        assert KA._sync_calls_in_loops(fn) == []

    def test_hot_path_registry_matches_source(self):
        r = F.Report(tool="audit")
        for module, fns in KA.HOT_PATH_FUNCTIONS.items():
            KA.check_host_sync(r, module, fns)
        stale = [f for f in r.findings if "stale" in f.message]
        assert stale == [], "\n".join(f.render() for f in stale)
        assert r.findings == [], "\n".join(f.render() for f in r.findings)
        assert r.checked["audit.host-sync"] == 5


class TestLaunchRecord:
    """On the card a kernel is handed addresses: the record names each by
    the allocation that starts there (emulated here with a launch that does
    nothing)."""

    @pytest.fixture
    def silent_launch(self, monkeypatch):
        from repro_torch.kernels import xor_delta

        monkeypatch.setattr(xor_delta, "launch", lambda *args: None)
        return xor_delta

    def test_addresses_name_their_allocations(self, silent_launch):
        def run(n, dev):
            base = torch.zeros((64, 8, 128), dtype=torch.int32)
            new = base.clone()
            new[:n] += 1  # a view at new's address must not rename it
            silent_launch.launch("block_xor_delta", dev, base.data_ptr(),
                                 new[:n].data_ptr(), torch.empty_like(base).data_ptr(), 64)

        p = KA.BucketProbe("test.launch", run, (5, 6))
        r = F.Report(tool="audit")
        KA.check_bucket_probe(r, p, CPU)
        assert r.findings == []
        sig = KA.signature(5, p, CPU)
        assert sig.count("('torch.int32', (64, 8, 128))") == 3 and sig.endswith("64)")

    def test_int64_allocation_handed_to_a_launch_flags(self, silent_launch):
        def wrapper(x):
            wide = x.to(torch.int64)
            silent_launch.launch("block_hash", CPU, wide.data_ptr(), x.data_ptr(), 8)
            return x.clone()

        (f,) = _run(wrapper, torch.arange(8, dtype=torch.int32)).findings
        assert f.severity == F.Severity.ERROR and "block_hash:int64" in f.message


class TestBucketRule:
    def test_identity_bucket_rejected(self):
        c = KA.BucketContract("test.identity", lambda k: k, "pow2", max_check=64)
        r = F.Report(tool="audit")
        KA.check_bucket_contract(r, c)
        (f,) = r.by_rule("audit.shape-bucket")
        assert f.severity == F.Severity.ERROR

    def test_undersized_bucket_rejected(self):
        c = KA.BucketContract("test.halve", lambda k: max(8, k // 2), "pow2", max_check=64)
        r = F.Report(tool="audit")
        KA.check_bucket_contract(r, c)
        assert any("dropped data" in f.message for f in r.findings)

    def test_real_buckets_pass(self):
        r = F.Report(tool="audit")
        for c in KA.bucket_contracts():
            KA.check_bucket_contract(r, c)
        assert r.findings == [], "\n".join(f.render() for f in r.findings)

    def test_probe_catches_unbucketed_shapes(self):
        # a probe whose "bucket" is the raw size hands the kernel two shapes
        p = KA.BucketProbe("test.raw",
                           lambda n, dev: segment_ops.segment_min_rows(torch.zeros((n, 128))),
                           (8, 16))
        r = F.Report(tool="audit")
        KA.check_bucket_probe(r, p, CPU)
        (f,) = r.by_rule("audit.shape-bucket")
        assert "(8, 128)" in f.message and "(16, 128)" in f.message

    def test_real_probes_pass(self):
        r = F.Report(tool="audit")
        for p in KA.bucket_probes():
            KA.check_bucket_probe(r, p, CPU)
        assert r.findings == [], "\n".join(f.render() for f in r.findings)


class TestArgWriteRule:
    def test_in_place_op_on_argument_flags(self):
        def wrapper(x):
            x.add_(1)
            return x.clone()

        (f,) = _run(wrapper, torch.zeros(16), check=KA.check_arg_write).findings
        assert f.severity == F.Severity.ERROR and "add_" in f.message

    def test_write_no_dispatch_sees_is_caught_by_bytes(self):
        # a launch writes through a pointer: no aten op, only the bytes tell
        def wrapper(x):
            ctypes.memset(x.data_ptr(), 0, x.numel() * x.element_size())
            return torch.empty_like(x)

        (f,) = _run(wrapper, torch.ones(16), check=KA.check_arg_write).findings
        assert f.severity == F.Severity.ERROR
        assert "bytes changed" in f.message and "add_" not in f.message

    def test_wrapper_that_copies_is_clean(self):
        r = _run(lambda x: x.clone().add_(1), torch.zeros(16), check=KA.check_arg_write)
        assert r.findings == []

    def test_solver_loops_are_notes(self):
        for target in KA.audit_targets():
            if target.name.endswith(("prim_loop", "mp_loop")):
                r = F.Report(tool="audit")
                KA.check_arg_write(r, target, KA.run_target(target, CPU))
                (f,) = r.findings
                assert f.severity == F.Severity.NOTE and "bytes changed" in f.message


class TestAllowlist:
    def test_prefix_downgrades_to_note(self):
        r = F.Report(tool="audit")
        KA._emit(r, "audit.dtype64-source", F.Severity.ERROR,
                 "repro_torch.kernels.block_diff", "m")
        (f,) = r.findings
        assert f.severity == F.Severity.NOTE and "allowlisted" in f.message

    def test_non_matching_subject_keeps_severity(self):
        r = F.Report(tool="audit")
        KA._emit(r, "audit.arg-write", F.Severity.ERROR,
                 "kernels.segment_ops.min_argmin_1d", "m")
        (f,) = r.findings
        assert f.severity == F.Severity.ERROR


def test_source_scan_flags_64_bit_tokens(tmp_path, monkeypatch):
    (tmp_path / "wide_mod.py").write_text(
        "import torch\n"
        "def f(x):\n"
        "    '''torch.int64 in a docstring does not count'''\n"
        "    return x.long(), torch.float64, x.double()\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    r = F.Report(tool="audit")
    KA.check_dtype64_source(r, "wide_mod")
    (f,) = r.findings
    assert f.severity == F.Severity.ERROR and "[4]" in f.message


def test_auditor_and_clis_leave_jax_out():
    code = (
        "import sys, repro_torch.analysis.kernel_audit as KA, repro_torch.analysis.cli,"
        " repro_torch.obs.cli;"
        "KA.audit_targets(); KA.bucket_contracts(); KA.bucket_probes();"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')];"
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
