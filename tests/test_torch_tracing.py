"""The port's spans (``gpr_tpu_torch.tracing``) on the CPU: nothing is
recorded without a profiler; under ``torch.profiler`` a streaming fit
records its evaluations, iterations, host reads and the training step's
spans, nested, each under its evaluation, and each beside the profiler's
own host event; the fit's answer does not change; the predictors and the
collectives record theirs; ``utils.timing`` prints its line and records a
span."""

import collections
import io
import threading

import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from gpr_tpu_torch import tracing, utils
from gpr_tpu_torch.kernels.se_iso import SeIso
from gpr_tpu_torch.models.streaming import (
    predict_means_blocked,
    predict_variances_blocked,
    streaming_trained,
)
from gpr_tpu_torch.optim import fit, make_pack

F64 = torch.float64


@pytest.fixture(autouse=True)
def fresh_recording():
    """An empty recording and one torch thread (small tensors under
    several pytest workers), both restored after."""
    kept = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(kept)


def _data(n=400, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(n, d, generator=g, dtype=F64)
    y = torch.sin(X.sum(1)) + 0.1 * torch.randn(n, generator=g, dtype=F64)
    return X, y


def _fit(X, y, init_state=None, max_iter=3):
    pack = make_pack(SeIso(0.0, 0.0, device="cpu", dtype=F64),
                     X[:8].clone(), 0.5)
    return fit(X, y, pack, streaming_block_size=128, max_iter=max_iter,
               dispatch_iters=2, init_state=init_state)[3]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, tracing.recorded(), prof.profiler.kineto_results.events()


def _one(name):
    with tracing.span(name):
        pass


def test_no_profiler_records_nothing():
    X, y = _data()
    _fit(X, y)
    assert tracing.recorded() == [] and tracing.dropped() == 0


def test_fit_spans_nest_under_their_evaluation():
    X, y = _data()
    plain = _fit(X, y)
    st, rec, events = _traced(lambda: _fit(X, y))
    # the answer is the profiler-free one, bit for bit
    for a, b in ((plain.x, st.x), (plain.f, st.f), (plain.g, st.g)):
        assert torch.equal(a, b)
    assert (plain.n_evals, plain.n_iter) == (st.n_evals, st.n_iter)

    names = collections.Counter(s.name for s in rec)
    assert names["gpr.optim.eval"] == st.n_evals
    for name in ("gpr.optim.iter", "gpr.optim.direction",
                 "gpr.optim.update"):
        assert names[name] == st.n_iter, name
    # one a line-search evaluation (the fallback's has none)
    assert st.n_iter <= names["gpr.optim.line_search"] < st.n_evals
    for name in ("gpr.step.inducing", "gpr.step.stats", "gpr.step.epilogue",
                 "gpr.step.backward", "gpr.step.stats_bwd"):
        assert names[name] == st.n_evals, name
    # one an evaluation, and fit's own of the answer
    assert names["gpr.optim.unpack"] == st.n_evals + 1
    assert names["gpr.optim.host_read"] >= 5 * st.n_evals

    by_seq = {s.seq: s for s in rec}
    parent_name = {s.seq: by_seq[s.parent].name if s.parent in by_seq
                   else None for s in rec}
    for s in rec:
        if s.name == "gpr.optim.eval":
            assert s.root == s.seq
            assert parent_name[s.seq] in (None, "gpr.optim.iter")
        elif s.name in ("gpr.optim.direction", "gpr.optim.line_search",
                        "gpr.optim.update"):
            assert parent_name[s.seq] == "gpr.optim.iter"
        elif s.name.startswith("gpr.step.") or (
                s.name == "gpr.optim.unpack" and s.root != -1):
            # the root is the evaluation the step ran in
            assert by_seq[s.root].name == "gpr.optim.eval"
            assert by_seq[s.root].t0_ns <= s.t0_ns <= s.t1_ns \
                <= by_seq[s.root].t1_ns
            want = ("gpr.step.backward" if s.name == "gpr.step.stats_bwd"
                    else "gpr.optim.eval")
            assert parent_name[s.seq] == want, s
        if s.parent in by_seq:
            p = by_seq[s.parent]
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns
    assert {s.fields.get("rows") for s in rec
            if s.name == "gpr.step.stats"} == {X.shape[0]}

    # each record beside the profiler's host event of its name, but the
    # iteration's and the evaluation's, kept in memory only
    host = collections.defaultdict(list)
    for e in events:
        if e.name().startswith("gpr."):
            assert str(e.device_type()).endswith("CPU")
            host[e.name()].append(e.start_ns())
    memory = ("gpr.optim.iter", "gpr.optim.eval")
    assert not set(memory) & set(host)
    timeline = [s for s in rec if s.name not in memory]
    assert sum(map(len, host.values())) == len(timeline)
    for s in timeline:
        assert min(abs(t - s.t0_ns) for t in host[s.name]) < 1_000_000


def test_eval_count_is_the_resumed_change_in_n_evals():
    X, y = _data(seed=1)
    first = _fit(X, y, max_iter=2)
    st, rec, _ = _traced(lambda: _fit(X, y, init_state=first, max_iter=4))
    evals = sum(s.name == "gpr.optim.eval" for s in rec)
    assert evals == st.n_evals - first.n_evals > 0


def test_root_is_inherited_on_another_thread():
    """A span opened on another thread while the caller waits (as
    autograd's device thread runs the custom backward, with the profiler's
    state handed over) belongs to the caller's evaluation; a thread the
    profiler does not follow records nothing and ends nothing."""

    def work():
        _one("gpr.unfollowed")  # the profiler is off on a new thread
        with tracing._Open("gpr.step.stats_bwd", False, {"rows": 3}):
            pass

    def evaluation():
        with tracing.span("gpr.optim.eval", root=True):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
        _one("gpr.after")

    _, rec, _ = _traced(evaluation)
    bwd, ev, after = rec
    assert ev.name == "gpr.optim.eval" and bwd.root == ev.seq
    assert after.name == "gpr.after" and after.root == -1
    assert bwd.parent == ev.seq and bwd.thread != ev.thread


def test_recording_restarts_after_the_profiler_was_off(monkeypatch):
    _traced(lambda: _one("gpr.a"))
    assert [s.name for s in tracing.recorded()] == ["gpr.a"]
    _one("gpr.b")  # no profiler: the recording ends ...
    assert [s.name for s in tracing.recorded()] == ["gpr.a"]  # ... kept

    def many():
        for _ in range(5):
            _one("gpr.c")

    monkeypatch.setattr(tracing, "LIMIT", 3)
    _traced(many)
    assert [s.name for s in tracing.recorded()] == ["gpr.c"] * 3
    assert tracing.dropped() == 2
    assert tracing.host_read(torch.tensor(2.5, dtype=F64)) == 2.5


def test_predictor_spans_are_roots():
    X, y = _data(n=300)
    k = SeIso(0.0, 0.0, device="cpu", dtype=F64)
    sigma2 = torch.tensor(0.2, dtype=F64)
    tr = streaming_trained(k, X[:8], sigma2, X, y, block_size=128)
    xt = X[:50]

    def serve():
        return (predict_means_blocked(k, X[:8], tr.coeffs, xt,
                                      block_size=32),
                predict_variances_blocked(k, X[:8],
                                          tr.model.inducing.chol_km,
                                          tr.model.r_mat, xt, sigma2,
                                          block_size=32))

    plain = serve()
    got, rec, _ = _traced(serve)
    assert all(torch.equal(a, b) for a, b in zip(plain, got))
    names = [s.name for s in rec]
    assert names == ["gpr.predict.means", "gpr.predict.inverses",
                     "gpr.predict.variances"]
    means, inv, var = rec
    assert means.root == means.seq and var.root == var.seq
    assert inv.parent == var.seq and inv.root == var.seq
    assert means.fields == {"points": 50} == var.fields


def test_collective_spans_on_a_one_rank_mesh(tmp_path, monkeypatch):
    from gpr_tpu_torch.parallel import spmd

    monkeypatch.setenv("GPR_TPU_PLATFORM", "cpu")

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        mesh = spmd.make_mesh(1)
        x0 = torch.tensor([0.5, -1.0], dtype=F64)

        def f(x):
            return mesh.allsum(x * x).sum()

        (v, g), rec, _ = _traced(
            lambda: spmd.sharded_value_and_grad(mesh, f, x0))
    finally:
        dist.destroy_process_group()
    assert float(v) == 1.25 and torch.equal(g, 2 * x0)
    by_seq = {s.seq: s for s in rec}
    ev = next(s for s in rec if s.name == "gpr.optim.eval")
    coll = [(s.name, by_seq[s.parent].name, s.fields["bytes"]) for s in rec
            if s.name.startswith("gpr.parallel.")]
    # forward's all-reduce, the cotangent's (in the backward), the
    # gradient's, the value's broadcast
    assert coll == [
        ("gpr.parallel.all_reduce", "gpr.optim.eval", 16),
        ("gpr.parallel.all_reduce", "gpr.step.backward", 16),
        ("gpr.parallel.all_reduce", "gpr.optim.eval", 16),
        ("gpr.parallel.broadcast", "gpr.optim.eval", 8),
    ]
    assert all(s.root == ev.seq for s in rec)


def test_timing_prints_and_records():
    stream = io.StringIO()
    with utils.timing("region", stream=stream):
        torch.ones(4).sum()
    line = stream.getvalue()
    assert line.startswith("region: ") and line.endswith("s\n")
    assert tracing.recorded() == []

    def timed():
        with utils.timing("traced", stream=stream):
            torch.ones(4).sum()

    _, rec, events = _traced(timed)
    assert [s.name for s in rec] == ["gpr.timing: traced"]
    assert any(e.name() == "gpr.timing: traced" for e in events)
    assert stream.getvalue().splitlines()[-1].startswith("traced: ")
