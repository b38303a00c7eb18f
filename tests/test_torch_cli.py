"""The port's two CLIs against the JAX package's, on the CPU
(``--device cpu``), called in process through their ``main``:

* ``python -m repro_torch.analysis fsck --json`` reports the same (rule,
  severity, subject) set and exit status as ``python -m repro.analysis
  fsck --json``, on the synthetic store committed by either package
  (``build_synthetic_store``; the stores are interchangeable) and on each
  with one object deleted; ``--synthetic`` exits 0;
* ``python -m repro_torch.obs convert`` of a spans JSONL written by the
  JAX tracer gives the JAX ``convert``'s Chrome trace;
* ``summary --synthetic --json`` reports the JAX CLI's span names and
  counts, and its service counters; ``prom`` the same metric names;
* ``overhead`` runs at a small ``--reps``; the CLIs refuse without a card
  unless given ``--device cpu``.
"""

import contextlib
import io
import json
import re

import pytest

import repro.obs as jobs
from repro.analysis import cli as jax_analysis_cli
from repro.obs import cli as jax_obs_cli
from repro_torch.analysis import cli as analysis_cli
from repro_torch.obs import cli as obs_cli


def call(main, argv):
    """(exit status, stdout) of a CLI's ``main``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def fsck(main, root, device=()):
    rc, out = call(main, ["fsck", str(root), "--json", *device])
    report = json.loads(out)
    return rc, {(f["rule"], f["severity"], f["subject"]) for f in report["findings"]}


def delete_one_object(root) -> None:
    objects = sorted((root / "objects").rglob("*.zst"))
    objects[len(objects) // 2].unlink()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fsck_reports_equal(tmp_path, writer):
    root = tmp_path / "store"
    if writer == "jax":
        jax_analysis_cli.build_synthetic_store(root)
    else:
        analysis_cli.build_synthetic_store(root, device="cpu").close()
    port = fsck(analysis_cli.main, root, ["--device", "cpu"])
    assert port == fsck(jax_analysis_cli.main, root)
    assert port[0] == 0
    delete_one_object(root)
    port = fsck(analysis_cli.main, root, ["--device", "cpu"])
    assert port == fsck(jax_analysis_cli.main, root)
    rc, found = port
    assert rc == 1 and "fsck.missing-object" in {rule for rule, _, _ in found}


def test_fsck_synthetic_and_usage_errors(tmp_path):
    rc, out = call(analysis_cli.main, ["fsck", "--synthetic", "--device", "cpu"])
    assert rc == 0 and "0 new finding(s)" in out
    assert call(analysis_cli.main, ["fsck", "--device", "cpu"])[0] == 2
    assert call(analysis_cli.main, ["fsck", str(tmp_path), "--synthetic",
                                    "--device", "cpu"])[0] == 2


def test_clis_refuse_without_a_card(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(analysis_cli.main, ["fsck", "--synthetic"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call(obs_cli.main, ["overhead", "--reps", "1"])


def test_convert_of_jax_spans_equals_jax_convert(tmp_path):
    tracer = jobs.Tracer(enabled=True)
    ticks = iter(range(100))
    tracer.now = lambda: next(ticks) * 0.25
    with tracer.span("svc.checkout", vid=3):
        with tracer.span("mat.plan"):
            pass
        tracer.add_event("svc.queue_wait", 0.1, 0.2, key="v3")
    with tracer.span("store.commit", nbytes=4096):
        pass
    spans = tmp_path / "spans.jsonl"
    jobs.dump_spans_jsonl(tracer, spans)
    assert call(jax_obs_cli.main, ["convert", str(spans), str(tmp_path / "jax.json")])[0] == 0
    assert call(obs_cli.main, ["convert", str(spans), str(tmp_path / "port.json")])[0] == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == want


@pytest.fixture(scope="module")
def summaries():
    """Both packages' ``summary --synthetic --json``."""
    jax_rc, jax_out = call(jax_obs_cli.main, ["summary", "--synthetic", "--json"])
    rc, out = call(obs_cli.main, ["summary", "--synthetic", "--json", "--device", "cpu"])
    assert jax_rc == rc == 0
    return json.loads(jax_out), json.loads(out)


def test_summary_span_names_and_counts(summaries):
    want, got = summaries
    assert {k: v["count"] for k, v in got["spans"].items()} == \
        {k: v["count"] for k, v in want["spans"].items()}
    assert got["counters"] == want["counters"]


def metric_names(text: str) -> set:
    return {re.split(r"[{ ]", line, maxsplit=1)[0]
            for line in text.splitlines() if line and not line.startswith("#")}


def test_prom_metric_names(tmp_path):
    _, want = call(jax_obs_cli.main, ["prom"])
    rc, got = call(obs_cli.main, ["prom", "--device", "cpu"])
    assert rc == 0 and metric_names(got) == metric_names(want)
    assert len(metric_names(got)) > 10


def test_summary_writes_valid_trace_and_prom(tmp_path):
    trace, prom = tmp_path / "t.json", tmp_path / "m.prom"
    rc, out = call(obs_cli.main, ["summary", "--synthetic", "--device", "cpu",
                                  "--trace-out", str(trace), "--prom", str(prom)])
    assert rc == 0 and "Perfetto-loadable" in out and "tradeoff (latest sample" in out
    assert json.loads(trace.read_text())["traceEvents"]
    assert metric_names(prom.read_text())


def test_overhead_runs(tmp_path):
    rc, out = call(obs_cli.main, ["overhead", "--reps", "5", "--chain", "4",
                                  "--budget-pct", "100", "--device", "cpu"])
    assert rc == 0 and "overhead gate ok" in out
    report = json.loads(out[: out.rindex("}") + 1])
    assert report["instrumentation_points"] > 0 and report["warm_checkout_us"] > 0
