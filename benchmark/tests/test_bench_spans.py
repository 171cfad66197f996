"""The readers of the program's spans (``spans.py`` and the five
``metrics/`` files that use it): each on a synthetic recording, None where
the program has no spans or the run was not traced, every one read in the
traced CPU runs of the cells that list it, and the recording exact to the
window across traced cells in one process."""

import json
import sys
import time

import pytest

import harness
import run
from gpr_tpu_torch import tracing
from gpr_tpu_torch.tracing import Span

SHRINK = {"config": {"n": 2400, "m": 10, "block": 512},
          "traffic": {"pool_points": 30000, "points": [64, 4096],
                      "check_rate": 0.05}}
MS = 1_000_000  # ns

NEW = ("optim.host_reads_per_eval", "optim.self_ms_per_eval",
       "step.host_ms_per_eval", "step.host_ms_per_eval.plain_loop",
       "predict.host_ms_per_mpt")


def _span(name, t0, t1, seq, parent=-1, root=-1, **fields):
    return Span(name, t0 * MS, t1 * MS, seq, parent, root, 1, fields)


def _train_record():
    """One iteration (1-41 ms) holding its direction (1-4 ms, one read),
    two evaluations and three reads; one read outside it.  Each
    evaluation: stats 2 ms, epilogue 1 ms, backward 3 ms (holding
    stats_bwd)."""
    out = [_span("gpr.optim.host_read", 0, 1, 0),
           _span("gpr.optim.host_read", 2, 3, 101, 100),
           _span("gpr.optim.direction", 1, 4, 100, 1)]
    out.append(_span("gpr.optim.iter", 1, 41, 1))
    seq = 2
    for start in (5, 20):
        ev = seq
        out += [
            _span("gpr.step.stats", start, start + 2, ev + 1, ev, ev,
                  rows=10),
            _span("gpr.step.epilogue", start + 2, start + 3, ev + 2, ev, ev),
            _span("gpr.step.stats_bwd", start + 3, start + 5, ev + 4,
                  ev + 3, ev, rows=10),
            _span("gpr.step.backward", start + 3, start + 6, ev + 3, ev, ev),
            _span("gpr.optim.eval", start, start + 8, ev, 1, ev),
            _span("gpr.optim.host_read", start + 8, start + 9, ev + 5, 1),
        ]
        seq += 6
    out.append(_span("gpr.optim.host_read", 39, 40, seq, 1))
    return out


def _serve_record():
    return [
        _span("gpr.predict.means", 0, 2, 0, root=0, points=500_000),
        _span("gpr.predict.inverses", 2, 3, 2, 1, 1),
        _span("gpr.predict.variances", 2, 5, 1, root=1, points=500_000),
    ]


@pytest.fixture
def record(monkeypatch):
    def use(spans):
        monkeypatch.setattr(tracing, "recorded", lambda: list(spans))
    return use


TRAIN = {"kind": "train", "trace": {}, "evals": 2}
SERVE = {"kind": "serve", "trace": {}}


@pytest.mark.parametrize("metric,evidence,spans,value", [
    # 5 reads over 2 evaluations
    ("optim.host_reads_per_eval", TRAIN, _train_record(), 2.5),
    # 40 ms less 2 x 8 of evaluations and 4 x 1 of reads, over 2
    ("optim.self_ms_per_eval", TRAIN, _train_record(), 10.0),
    # (2 + 1 + 3) a evaluation: stats_bwd is inside backward
    ("step.host_ms_per_eval", TRAIN, _train_record(), 6.0),
    ("step.host_ms_per_eval.plain_loop", TRAIN, _train_record(), 6.0),
    # 2 ms and 3 ms, each over half a million points
    ("predict.host_ms_per_mpt", SERVE, _serve_record(), 10.0),
    # the other kind of traffic, or nothing of the metric's
    ("optim.host_reads_per_eval", SERVE, _serve_record(), None),
    ("predict.host_ms_per_mpt", TRAIN, _train_record(), None),
    ("optim.self_ms_per_eval", TRAIN, _serve_record(), None),
    ("step.host_ms_per_eval", TRAIN, [], None),
    # an untraced run
    ("optim.host_reads_per_eval", {"kind": "train", "trace": None},
     _train_record(), None),
])
def test_reader_on_a_synthetic_record(record, metric, evidence, spans,
                                      value):
    record(spans)
    got = harness.reader(metric).read(evidence)
    assert got == pytest.approx(value) if value is not None else got is None


@pytest.mark.parametrize("metric", NEW)
def test_reader_without_the_program_spans(monkeypatch, metric):
    """A program without ``tracing`` (the parent of the change that added
    it): the readers return None and do not raise."""
    import gpr_tpu_torch

    monkeypatch.setitem(sys.modules, "gpr_tpu_torch.tracing", None)
    monkeypatch.delattr(gpr_tpu_torch, "tracing")
    ev = {**(SERVE if metric.startswith("predict") else TRAIN)}
    assert harness.reader(metric).read(ev) is None


def _run(manifest, workload, capsys, seed):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", "1.0", "--trace", "1"])
    line = run.run_cell(manifest, args, device="cpu", t_start=time.time(),
                        shrink=SHRINK)
    counted = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, counted["launches"]


def test_traced_cells_read_the_new_metrics_window_exact(manifest, capsys):
    """Three traced cells in one process: each reads every new metric that
    lists it, and the recording holds that cell's window alone (its
    evaluations are the window's, or its predictor calls its requests)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i, workload in enumerate(["seiso-1m-m300.train",
                                      "seiso-1m-m300.serve",
                                      "sefat-1m-m1000.train"]):
            line, counted = _run(manifest, workload, capsys, 2**33 + i)
            assert line["correct"], line["checks"]
            listed = {m["name"] for m in manifest["per_layer"]
                      if m["name"] in NEW
                      and workload in m["workloads"]}
            assert listed and listed <= set(line["metrics"])
            for name in listed:
                assert line["metrics"][name]["value"] > 0
            names = [s.name for s in tracing.recorded()]
            if workload.endswith(".train"):
                assert names.count("gpr.optim.eval") == counted["evals"]
                assert "gpr.predict.means" not in names
            else:
                assert names.count("gpr.predict.means") == \
                    counted["requests"]
                assert "gpr.optim.eval" not in names
    finally:
        torch.set_num_threads(n)
