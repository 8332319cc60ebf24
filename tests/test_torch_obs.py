"""The port's observability layer (``repro_torch.obs``) against the JAX
package's ``repro.obs``, on the CPU.

Each case of tests/test_obs.py is carried over to the port's copy: the
metrics registry, the span tracer, the warning dedup, the efficiency
report and the telemetry container.  On the same seeded counters the
port's ``Telemetry`` rates and ``efficiency_rows`` must equal the
reference's exactly; the report's batches run through
``repro_torch.run_batch(..., device="cpu", telemetry=True)``.
"""
import ast
import glob
import json
import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import report as jreport
from repro.obs.telemetry import Telemetry as JTelemetry
import repro_torch
from repro_torch.core import adaptive
from repro_torch.obs import metrics, oblog, report, trace
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.telemetry import TEL_KEYS, Telemetry, zero_counts
from torch_threads import one_thread  # noqa: F401 (one thread)

OBS = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "obs"


@pytest.fixture(autouse=True)
def _rearm_port_warnings():
    """The port's dedup is its own (the conftest re-arms the reference's)."""
    oblog.reset_warn_once()
    yield
    oblog.reset_warn_once()


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


def test_counter_gauge_histogram_roundtrip():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(4)
    reg.gauge("g").set(2.5)
    for v in (1.0, 3.0, 2.0):
        reg.histogram("h").observe(v)
    snap = reg.snapshot()
    assert snap["c"] == {"kind": "counter", "value": 5}
    assert snap["g"] == {"kind": "gauge", "value": 2.5}
    assert snap["h"]["count"] == 3
    assert snap["h"]["mean"] == pytest.approx(2.0)
    assert snap["h"]["min"] == 1.0 and snap["h"]["max"] == 3.0


@pytest.mark.parametrize("first,then", [("counter", "gauge"),
                                        ("gauge", "histogram"),
                                        ("histogram", "counter")])
def test_registry_created_on_first_touch_and_kind_clash(first, then):
    reg = MetricsRegistry()
    getattr(reg, first)("x")
    with pytest.raises(TypeError, match=f"already registered as {first}"):
        getattr(reg, then)("x")


def test_snapshot_sorted_and_reset():
    reg = MetricsRegistry()
    reg.counter("b").inc()
    reg.counter("a").inc()
    assert list(reg.snapshot()) == ["a", "b"]
    reg.reset()
    assert reg.snapshot() == {}


def test_export_jsonl_appends_self_contained_lines(tmp_path):
    reg = MetricsRegistry()
    path = str(tmp_path / "sub" / "metrics.jsonl")
    reg.counter("events").inc(3)
    reg.export_jsonl(path)
    reg.counter("events").inc()
    reg.export_jsonl(path, extra={"phase": "end"})
    lines = [json.loads(ln) for ln in open(path)]
    assert len(lines) == 2
    assert lines[0]["metrics"]["events"]["value"] == 3
    assert lines[1]["metrics"]["events"]["value"] == 4
    assert lines[1]["phase"] == "end"
    assert all("ts" in ln for ln in lines)


def test_global_registry_helpers_share_namespace():
    metrics.counter("test_torch_obs.shared").inc()
    assert metrics.REGISTRY.counter("test_torch_obs.shared").value >= 1


# ---------------------------------------------------------------------------
# span tracer
# ---------------------------------------------------------------------------


def test_span_records_name_duration_and_args():
    tr = trace.SpanTracer()
    with tr.span("outer", mode="test"):
        with tr.span("inner"):
            pass
    evs = tr.spans()
    assert [e["name"] for e in evs] == ["inner", "outer"]   # close order
    assert evs[1]["args"] == {"mode": "test"}
    assert all(e["dur_ns"] >= 0 for e in evs)


def test_traced_decorator_and_clear():
    tr = trace.SpanTracer()

    @tr.traced()
    def add(a, b):
        return a + b

    assert add(1, 2) == 3
    assert any("add" in e["name"] for e in tr.spans())
    tr.clear()
    assert tr.spans() == []


def test_span_recorded_even_when_body_raises():
    tr = trace.SpanTracer()
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    assert [e["name"] for e in tr.spans()] == ["boom"]


def test_ring_buffer_bounded():
    tr = trace.SpanTracer(maxlen=4)
    for i in range(10):
        with tr.span(f"s{i}"):
            pass
    evs = tr.spans()
    assert len(evs) == 4
    assert [e["name"] for e in evs] == ["s6", "s7", "s8", "s9"]


def test_export_chrome_trace_json(tmp_path):
    tr = trace.SpanTracer()
    with tr.span("step", chunk=1):
        pass
    path = tr.export_chrome(str(tmp_path / "trace.json"))
    doc = json.load(open(path))
    assert doc["displayTimeUnit"] == "ms"
    (ev,) = doc["traceEvents"]
    assert ev["ph"] == "X" and ev["name"] == "step"
    assert ev["dur"] >= 0 and ev["args"] == {"chunk": 1}


def test_profile_trace_records_span_without_profiler(monkeypatch, tmp_path):
    monkeypatch.delenv("REPRO_PROFILE", raising=False)
    monkeypatch.chdir(tmp_path)
    trace.clear()
    with trace.profile_trace("bench_label"):
        pass
    ev = next(e for e in trace.spans() if e["name"] == "bench_label")
    assert ev["args"] == {"profiled": False}
    assert os.listdir(tmp_path) == []              # no profiler output


@pytest.mark.parametrize("how", ["env", "arg"])
def test_profile_trace_writes_a_chrome_trace(monkeypatch, tmp_path, how):
    """With REPRO_PROFILE (or profile_dir) the window is profiled by
    torch.profiler and its Chrome trace lands under <dir>/<label>."""
    if how == "env":
        monkeypatch.setenv("REPRO_PROFILE", str(tmp_path))
        kw = {}
    else:
        monkeypatch.delenv("REPRO_PROFILE", raising=False)
        kw = {"profile_dir": str(tmp_path)}
    trace.clear()
    x = torch.ones(64, 64)
    with trace.profile_trace("window", **kw):
        (x @ x).sum()
    ev = next(e for e in trace.spans() if e["name"] == "window")
    assert ev["args"] == {"profiled": True}
    (path,) = glob.glob(str(tmp_path / "window" / "*.pt.trace.json"))
    doc = json.load(open(path))
    names = {e.get("name", "") for e in doc["traceEvents"]}
    assert any("mm" in n for n in names), sorted(names)[:20]


# ---------------------------------------------------------------------------
# warning dedup
# ---------------------------------------------------------------------------


def test_warn_once_dedups_by_default_key():
    before = (metrics.counter("obs.warnings.emitted").value,
              metrics.counter("obs.warnings.suppressed").value)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert oblog.warn_once("msg one") is True
        assert oblog.warn_once("msg one") is False
        assert oblog.warn_once("msg two") is True
    assert [str(w.message) for w in caught] == ["msg one", "msg two"]
    assert (metrics.counter("obs.warnings.emitted").value,
            metrics.counter("obs.warnings.suppressed").value) == (
        before[0] + 2, before[1] + 1)
    assert oblog.seen_count() == 2


def test_warn_once_explicit_key_spans_message_variants():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        oblog.warn_once("detail A", key=("fallback", "reason1"))
        oblog.warn_once("detail B", key=("fallback", "reason1"))
        oblog.warn_once("detail C", key=("fallback", "reason2"))
    assert [str(w.message) for w in caught] == ["detail A", "detail C"]


def test_reset_warn_once_rearms():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        oblog.warn_once("again")
        oblog.reset_warn_once()
        oblog.warn_once("again")
    assert len(caught) == 2


def test_plan_fallback_warning_fires_once_per_reason():
    """A sweep calling run_batch repeatedly with a demoting config warns
    ONCE per distinct fallback reason, not once per call."""
    from repro_torch.core.engineplan.plan import PlanFallbackWarning

    # a filter baseline has no coefficient-only form, so an explicit
    # gram request demotes to the stream plane (with a warning)
    specs = [repro_torch.TrialSpec(byz=(2, 5), attack="drift", steps=5,
                                   q=0.4, seed=0, d=4, n_data=16,
                                   mode="filter:median")]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for _ in range(3):
            repro_torch.run_batch(specs, device="cpu", data_plane="gram")
    fallback = [w for w in caught if issubclass(w.category,
                                                PlanFallbackWarning)]
    assert len(fallback) == 1


# ---------------------------------------------------------------------------
# efficiency report
# ---------------------------------------------------------------------------


def _tiny_batch():
    specs = [
        repro_torch.TrialSpec(byz=(2, 5), attack="drift", steps=60, q=0.4,
                              seed=0, d=8, n_data=32),
        repro_torch.TrialSpec(byz=(2, 5), attack="drift", steps=60, q=0.4,
                              seed=1, d=8, n_data=32),
        repro_torch.TrialSpec(byz=(1,), attack="noise", steps=60, q=0.2,
                              seed=2, d=8, n_data=32),
    ]
    return repro_torch.run_batch(specs, device="cpu", telemetry=True)


def test_efficiency_rows_group_and_bound():
    batch = _tiny_batch()
    rows = {r["scenario"]: r for r in report.efficiency_rows(batch)}
    assert set(rows) == {"drift/f=2", "noise/f=1"}
    dr = rows["drift/f=2"]
    assert dr["trials"] == 2 and dr["steps"] > 0
    # the expected column is the eq-2 closed form at the group's mean q
    assert dr["expected_overhead"] == pytest.approx(
        1.0 - adaptive.com_eff(dr["q_mean"], 2))
    assert 0.0 < dr["observed_overhead"] < 1.0
    # the reference's report on the same batch gives the same rows
    assert report.efficiency_rows(batch) == jreport.efficiency_rows(batch)


def test_render_report_table_and_missing_telemetry():
    batch = _tiny_batch()
    text = report.render_report(batch)
    assert text == jreport.render_report(batch)
    lines = text.splitlines()
    assert lines[0].split()[0] == "scenario"
    assert len(lines) == 2 + 2                      # header, rule, 2 groups
    no_tel = repro_torch.run_batch([repro_torch.TrialSpec(
        byz=(), attack="none", steps=5, q=0.5, d=4, n_data=16)],
        device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        report.render_report(no_tel)


@pytest.mark.parametrize("q,f", [(0.0, 0), (0.4, 2), (1.0, 3), (0.25, 1)])
def test_adaptive_bounds_match_reference(q, f):
    from repro.core import adaptive as jadaptive

    assert adaptive.com_eff(q, f) == jadaptive.com_eff(q, f)
    for p in (0.0, 0.5, 0.8):
        assert adaptive.prob_faulty_update(q, f, p) == \
            jadaptive.prob_faulty_update(q, f, p)


def _module_scope_imports(path):
    """Top-level module names imported at module scope (not inside a
    function) by ``path``."""
    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    return names


@pytest.mark.parametrize("path", sorted(OBS.glob("*.py")),
                         ids=lambda p: p.name)
def test_obs_imports_no_core_at_module_scope(path):
    """Layering contract: the obs modules sit beside the engine; the plan
    layer imports them, not the other way round (the report imports
    ``repro_torch.core.adaptive`` inside its function)."""
    for name in _module_scope_imports(path):
        assert not name.startswith(("repro_torch.core", "repro_torch.kernels",
                                    "repro_torch.models",
                                    "repro_torch.serving")), (path, name)


def test_telemetry_container_derived_rates():
    counts = zero_counts(2)
    counts["steps"][:] = (10, 0)
    counts["checks"][:] = (4, 0)
    counts["redundant_steps"][:] = (5, 0)
    counts["detects"][:] = (2, 0)
    tel = Telemetry.from_counts(counts, q_traces=[[0.2, 0.6], []])
    assert len(tel) == 2
    assert tel.redundancy_overhead[0] == pytest.approx(0.5)
    assert tel.check_rate[0] == pytest.approx(0.4)
    assert tel.detection_rate[0] == pytest.approx(0.5)
    # zero-step trial: rates well-defined (0), q stats NaN
    assert tel.redundancy_overhead[1] == 0.0
    assert np.isnan(tel.q_mean[1]) and np.isnan(tel.q_final[1])
    assert tel.q_mean[0] == pytest.approx(0.4)
    assert tel.q_final[0] == pytest.approx(0.6)
    row = tel.per_trial(0)
    assert set(TEL_KEYS) <= set(row)
    assert tel.totals()["steps"] == 10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_telemetry_rates_and_rows_equal_reference(seed):
    """The same seeded counters and q-traces through both containers:
    every rate, per-trial row, total and efficiency row equal."""
    from repro.obs.telemetry import TEL_KEYS as JTEL_KEYS

    assert TEL_KEYS == JTEL_KEYS
    rng = np.random.default_rng(seed)
    B = 7
    counts = {k: rng.integers(0, 50, size=B) for k in TEL_KEYS}
    counts["steps"][0] = 0
    qtr = [rng.random(int(n)).tolist() for n in counts["steps"]]
    specs = [repro_torch.TrialSpec(byz=tuple(range(int(rng.integers(0, 3)))),
                                   attack=("drift", "noise")[b % 2],
                                   label=f"t{b}") for b in range(B)]
    tp = Telemetry.from_counts(counts, specs=specs, q_traces=qtr)
    tj = JTelemetry.from_counts(counts, specs=specs, q_traces=qtr)
    for attr in ("redundancy_overhead", "check_rate", "detection_rate",
                 "q_mean", "q_final"):
        np.testing.assert_array_equal(getattr(tp, attr), getattr(tj, attr),
                                      err_msg=attr)
    assert tp.labels == tj.labels
    assert tp.totals() == tj.totals()
    for b in range(1, B):
        assert tp.per_trial(b) == tj.per_trial(b)

    class _Batch:
        pass

    bp, bj = _Batch(), _Batch()
    bp.specs = bj.specs = specs
    bp.telemetry, bj.telemetry = tp, tj
    assert report.efficiency_rows(bp) == jreport.efficiency_rows(bj)
    assert report.render_report(bp) == jreport.render_report(bj)
