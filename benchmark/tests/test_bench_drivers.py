"""Each driver at a tiny size on the CPU through the plain loop, from the
look for a chip on (``run.run_cell``), and with the timed path broken
underneath: a fit that does not move, half of the rows left out (the mean
taken over the rest), the ranks' exchange left out, an answer altered
where it is produced.  Each fault has to turn ``correct`` false."""

import functools
import json
import time

import pytest
import torch

import harness
import run

SHRINK = {"config": {"n": 2400, "m": 10, "block": 512},
          "traffic": {"pool_points": 30000, "points": [64, 4096],
                      "check_rate": 0.05}}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(manifest, workload, trace=0, seed=2**31 + 5, seconds=1.0):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.run_cell(manifest, args, device="cpu", t_start=time.time(),
                        shrink=SHRINK)


CELLS = ["seiso-1m-m300.train", "sefat-1m-m1000.train",
         "seiso-1m-m300.serve", "airline-5.9m-seiso.train-dp4"]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(manifest, workload, capsys):
    line = _run(manifest, workload)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    wanted = {m["name"] for m in manifest["end_to_end"]
              if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == wanted
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert list(line)[-1] == "checks"
    json.dumps(line)
    out = capsys.readouterr()
    counted = json.loads(out.out.strip().splitlines()[-1])["launches"]
    for name in ("se_iso_stream_stats_fused_acc", "se_iso_stream_bwd_fused"):
        for ranks in counted.get("ranks", [counted]):
            assert ranks[name] == 0  # the CPU takes the plain loop
    assert out.err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", CELLS[:3])
def test_traced_run_reads_per_layer(manifest, workload):
    line = _run(manifest, workload, trace=1)
    assert line["correct"]
    assert line["device"]["window_s"] > 0
    assert "breakdown" in line
    names = {m["name"] for m in manifest["per_layer"]}
    assert set(line["metrics"]) <= names
    if workload.endswith(".train"):
        # counted, not traced: read on the CPU too
        counted = {m["name"] for m in manifest["per_layer"]
                   if m["source"] == "program_counter"
                   and workload in m.get("workloads", [workload])}
        assert any(n.startswith("step_mfu") for n in counted)
        assert counted <= set(line["metrics"])
    for name, v in line["metrics"].items():
        if name.endswith("_roofline") or "mfu" in name:
            assert 0 < v["value"] <= 100


def _unchanged(real):
    @functools.wraps(real)
    def chunk(fg, x0, *, init_state=None, max_iter=100, **kw):
        st = real(fg, x0, init_state=init_state, max_iter=0, **kw)
        return st._replace(n_iter=max_iter)
    return chunk


def _half_rows(real):
    def evidence(kernel, z, sigma2, X, y, **kw):
        return 2.0 * real(kernel, z, sigma2, X[::2], y[::2], **kw)
    return evidence


def _altered(real):
    def evidence(kernel, z, sigma2, X, y, **kw):
        kernel = type(kernel).of(*(getattr(kernel, f).detach()
                                   if f == "log_sf2" else getattr(kernel, f)
                                   for f in type(kernel).param_names))
        return real(kernel, z, sigma2, X, y, **kw)
    return evidence


@pytest.mark.parametrize("fault", ["unchanged", "half_rows", "altered"])
def test_training_faults_fail(manifest, monkeypatch, fault):
    from gpr_tpu_torch.models import streaming
    from gpr_tpu_torch.optim import lbfgs_device

    if fault == "unchanged":
        monkeypatch.setattr(lbfgs_device, "minimize_lbfgs_device",
                            _unchanged(lbfgs_device.minimize_lbfgs_device))
    else:
        wrap = _half_rows if fault == "half_rows" else _altered
        monkeypatch.setattr(streaming, "streaming_log_evidence",
                            wrap(streaming.streaming_log_evidence))
    line = _run(manifest, "seiso-1m-m300.train")
    assert not line["correct"], line["checks"]


def _faulty_rank(mesh, cell, limits):
    """fit_dp's rank with its statistics' all-reduce left out."""
    from drivers import fit_dp
    from gpr_tpu_torch.parallel import sharded

    sharded.allsum_fields = lambda mesh, obj: obj
    return fit_dp._rank(mesh, cell, limits)


def test_no_exchange_fails(manifest):
    from gpr_tpu_torch.parallel.spmd import run_spmd

    w, cfg, traffic = harness.resolve(manifest,
                                      "airline-5.9m-seiso.train-dp4")
    cell = harness.Cell(workload=w, config={**cfg, **SHRINK["config"]},
                        traffic=traffic, seed=11, seconds=1.0, trace=False,
                        chips=4, t_start=time.time(), device="cpu")
    limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")
    out = run_spmd(_faulty_rank, 4, cell, limits, platform="cpu",
                   timeout=300.0)
    assert not all(c.ok for c in out.checks), [c.line() for c in out.checks]


@pytest.mark.parametrize("fault", ["half_rows", "altered"])
def test_serving_faults_fail(manifest, monkeypatch, fault):
    from gpr_tpu_torch.models import streaming

    if fault == "half_rows":
        real = streaming.streaming_trained

        def trained(kernel, z, sigma2, X, y, **kw):
            return real(kernel, z, sigma2, X[::2], y[::2], **kw)

        monkeypatch.setattr(streaming, "streaming_trained", trained)
    else:
        real = streaming.predict_means_blocked

        def means(*a, **kw):
            out = real(*a, **kw)
            out[-max(1, out.shape[0] // 100):] = 0.0
            return out

        monkeypatch.setattr(streaming, "predict_means_blocked", means)
    line = _run(manifest, "seiso-1m-m300.serve")
    assert not line["correct"], line["checks"]


def test_control_fails(manifest):
    """The reference in TF32 put in the program's place fails the cell's
    limits (TF32 rounding is emulated, so this runs on the CPU too)."""
    from drivers import fit
    import fitloop
    from reference import gp

    w, cfg, traffic = harness.resolve(manifest, "seiso-1m-m300.train")
    cfg = {**cfg, "n": 20_000, "m": 50, "block": 4096}
    cell = harness.Cell(workload=w, config=cfg, traffic=traffic, seed=3,
                        seconds=1.0, trace=False, chips=1,
                        t_start=time.time(), device="cpu")
    limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")
    X, y, start, chunk_fn = fit.setup(cell)
    chunks, _ = fitloop.run_window(chunk_fn, start, traffic, 1.0)
    checks, _ = fitloop.compare(
        cfg, traffic, limits, 3, chunks, X, y, block=cfg["block"],
        program=lambda x: gp.neg_mean_evidence(cfg, x, X, y,
                                               precision="tf32",
                                               block=cfg["block"]))
    assert not all(c.ok for c in checks)


def test_program_tf32_path_fails_on_the_card(manifest, cuda_device):
    """The program's own TF32 switch on the plain loop (se_fat), at a size
    a test run holds, fails the cell's limits."""
    import calibrate
    from drivers import fit
    import fitloop

    w, cfg, traffic = harness.resolve(manifest, "sefat-1m-m1000.train")
    cfg = {**cfg, "n": 200_000, "m": 300}
    cell = harness.Cell(workload=w, config=cfg, traffic=traffic, seed=4,
                        seconds=3.0, trace=False, chips=1,
                        t_start=time.time(), device=cuda_device)
    limits = harness.load_json(harness.HERE / "limits" / f"{w['name']}.json")
    X, y, start, chunk_fn = fit.setup(cell)
    chunks, _ = fitloop.run_window(chunk_fn, start, traffic, 3.0)
    pack, _ = start("control")
    fg = calibrate.program_fg(cfg, pack)

    def program(x):
        with calibrate.tf32_program():
            return fg(x, X, y, 1.0 / cfg["n"])

    checks, _ = fitloop.compare(cfg, traffic, limits, 4, chunks, X, y,
                                block=cfg["block"], program=program)
    assert not all(c.ok for c in checks)
