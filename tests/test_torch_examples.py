"""The port's example twins (``examples/*_torch.py``) on the CPU.

Each twin's ``main(["--device", "cpu"])`` runs in this process and must
print what its JAX original prints wherever both are deterministic:

* quickstart: Figure 1's lines and the frontier table, held against the
  JAX example's own ``figure1()`` / ``frontier()`` run here;
* dataset_versions: every line, against the JAX example run here;
* serve_batched: the coalescing, batching and warm lines (7 of 8
  coalesced; the JAX example itself cannot be run to its end here, as its
  service's ``stop()`` spins on Python 3.12, ROADMAP Queue 3);
* serve_dataset: 0 invalidations across the interleaved commits and at
  least one purge after the repack, with a Chrome trace that validates;
* branching_finetune: 25 of the 26 checkouts served from the cache and the
  soup checked out byte for byte (the JAX example's jitted training is too
  slow to run here).

Importing any twin leaves ``jax`` and ``repro`` out of ``sys.modules``
(checked in a subprocess, as tests/test_torch_store.py does).
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
TWINS = ("quickstart", "dataset_versions", "serve_batched", "serve_dataset",
         "branching_finetune")


def load(stem: str):
    spec = importlib.util.spec_from_file_location(stem, ROOT / "examples" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(fn, *args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue().splitlines()


def test_quickstart_prints_the_jax_examples_figure1_and_frontier():
    twin, orig = load("quickstart_torch"), load("quickstart")
    facts, lines = run(twin.main, ["--device", "cpu"])
    _, fig1 = run(orig.figure1)
    _, table = run(orig.frontier)
    # the last Figure 1 line names the backend and the solve's time
    assert lines[: len(fig1) - 1] == fig1[:-1]
    assert lines[len(fig1):len(fig1) + len(table)] == table
    assert facts["figure1"]["mca"] == (11450.0, 13000.0)
    assert len(facts["frontier"]) == 7
    assert any(line.startswith("  checkout('release-1') verified") for line in lines)


def test_dataset_versions_prints_the_jax_examples_lines():
    facts, lines = run(load("dataset_versions_torch").main, ["--device", "cpu"])
    _, want = run(load("dataset_versions").main)
    assert lines == want
    assert facts["diff"] == "v1..v2: +0 -0 ~2 leaves (1.60 MB changed), 2 unchanged"


def test_serve_batched_coalesces_seven_of_eight():
    facts, lines = run(load("serve_batched_torch").main, ["--device", "cpu"])
    assert facts == {"coalesced": 7, "materialized": 1, "batch_dispatches": 1,
                     "warm_hits": 10}
    assert lines[:3] == [
        "[coalesce] 8 concurrent checkout('release') -> 7 coalesced, 1 materialized",
        "[batch] 5 distinct refs -> 1 checkout_many dispatch(es)",
        "[warm] repeat pass: 10 warm hits, 1 misses overall",
    ]
    assert lines[-1] == "OK ✓"


def test_serve_dataset_stays_warm_and_purges_on_repack(tmp_path):
    facts, lines = run(load("serve_dataset_torch").main,
                       ["--device", "cpu", "--trace-out", str(tmp_path / "trace.json")])
    assert facts["invalidations"] == 0 and facts["interleave_purges"] == 0
    assert facts["purges"] >= 1
    assert lines[0].startswith("[interleave] 13 commits between reads: ")
    assert lines[0].endswith(" 0 invalidations, 0 purges")
    assert lines[1].startswith("[fsck] ") and lines[1].endswith(" 0 finding(s)")
    assert lines[2] == f"[repack] storage re-optimized, cache purges={facts['purges']}"
    assert (tmp_path / "trace.json").stat().st_size > 0 and lines[-1] == "OK ✓"


def test_branching_finetune_serves_25_of_26_from_the_cache():
    facts, lines = run(load("branching_finetune_torch").main, ["--device", "cpu"])
    assert facts["hits_of_26"] == 25
    assert all(loss == loss for loss in facts["losses"])  # finite, not NaN
    assert lines[0] == "v1: base committed on 'main', tagged 'pretrained'"
    assert lines[1].startswith("version DAG: base->(2->3, 4)->merge v5; ")
    assert lines[-1] == "soup checkout verified byte-identical ✓"


def test_twins_leave_jax_and_repro_out():
    code = (
        "import importlib.util, sys\n"
        f"for stem in {[t + '_torch' for t in TWINS]!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(stem, {str(ROOT / 'examples')!r} + '/' + stem + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("stem", TWINS)
def test_default_device_needs_a_card(stem):
    # without a card the default (cuda) raises; nothing falls back to the CPU
    mod = load(f"{stem}_torch")
    with pytest.raises(RuntimeError):
        run(mod.main, [])
