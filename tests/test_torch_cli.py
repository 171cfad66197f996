"""The port's command-line trainer/predictor == gpr_tpu's, in f64 on the CPU.

Both CLIs run in process (``main(argv)`` with redirected stdio, stdin
carrying bytes so that the native CSV parser reads it) on the same CSV with
``-inducing-init first -seed 0``: the artifacts' params, inducing points and
coefficients agree within 1e-8 relative for the host trainer, ``-trainer
device`` (dense and streaming), ``-restarts``, ``-polish`` and the sparse
``-loo``; ``-cmd test`` prints the same text whichever package wrote the
artifact and whichever serves it; ``-checkpoint``/``-resume`` lands
bit-equal on the uninterrupted run; bad command lines get the JAX
package's messages and the flags of modules not ported yet (-cg,
-trainer sharded) exit naming their ROADMAP.md item.  The Laplace modes:
``test_torch_cli_laplace.py``; EP and multi-class:
``test_torch_cli_classify.py``.  The port's CSV binding is held against the JAX
package's, and one real process runs ``python -m gpr_tpu_torch.cli``.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpr_tpu.cli as jcli
import gpr_tpu_torch.cli as tcli
from gpr_tpu.io import checkpoint as jckpt
from gpr_tpu.io import native as jnative
from gpr_tpu_torch.io import checkpoint as tckpt
from gpr_tpu_torch.io import native as tnative

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"jax": jcli, "torch": tcli}
SE_FAT = ["-n-inducing", "6", "-dim-red", "2", "-log-het-sked", "-4",
          "-multiscale"]
BASE = ["-inducing-init", "first", "-seed", "0", "-max-iter", "6"]
CASES = {
    "host": SE_FAT,
    "host-streaming": SE_FAT + ["-block-size", "64"],
    "device": SE_FAT + ["-trainer", "device"],
    "device-streaming": SE_FAT + ["-trainer", "device", "-block-size", "64"],
    "restarts": SE_FAT + ["-restarts", "2"],
    "device-restarts": SE_FAT + ["-trainer", "device", "-restarts", "2"],
    "polish": SE_FAT + ["-polish", "100"],
    "loo": SE_FAT + ["-trainer", "device", "-loo"],
    "se_iso": ["-kernel", "se_iso", "-n-inducing", "6", "-amplitude", "1.5"],
    "matern52": ["-kernel", "matern52", "-n-inducing", "6", "-amplitude",
                 "1.5"],
    "matern52-device": ["-kernel", "matern52", "-n-inducing", "6",
                        "-trainer", "device", "-block-size", "64"],
    "lin_ard": ["-kernel", "lin_ard", "-n-inducing", "2"],
    "sum(se_iso,lin_ard)": ["-kernel", "sum(se_iso,lin_ard)",
                            "-n-inducing", "6"],
    "sm2-restarts": ["-kernel", "sm2", "-n-inducing", "6", "-restarts", "2"],
}


@pytest.fixture(autouse=True)
def _on_cpu(monkeypatch):
    monkeypatch.setenv("GPR_TPU_PLATFORM", "cpu")


@pytest.fixture(autouse=True)
def _trusted_jax_csv_library(monkeypatch):
    """Point the JAX package's CSV binding at the port's build of the same
    ``native/csvload.cc``.  The JAX binding links ``native/libcsvload.so``
    in place, so under several pytest workers one may load a library that
    another's linker is still writing, cache None and fall back to its
    Python reader, whose messages differ from the native parser's.  The
    port's build writes a temporary file and renames it, so the two
    bindings' Python code is compared on one whole library."""
    lib = tnative.get_lib()
    assert lib is not None, "the port's CSV library did not build"
    monkeypatch.setattr(jnative, "_LIB", str(tnative._lib_path()))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", False)


def run(pkg, args, stdin_text=""):
    """(rc, stdout, stderr) of one in-process CLI call; a SystemExit with a
    message lands in stderr with rc 1, as the interpreter reports it."""
    out, err = io.StringIO(), io.StringIO()
    old = sys.stdin
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin_text.encode()))
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = CLIS[pkg].main(list(args)) or 0
            except SystemExit as e:
                if isinstance(e.code, int) or e.code is None:
                    rc = e.code or 0
                else:
                    err.write(f"{e.code}\n")
                    rc = 1
    finally:
        sys.stdin = old
    return rc, out.getvalue(), err.getvalue()


def _csv(X, y=None):
    cols = X if y is None else np.column_stack([X, y])
    return "".join(",".join(f"{v:.10f}" for v in row) + "\n" for row in cols)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((150, 3))
    y = np.sin(2.0 * X[:, 0] - X[:, 1]) + 0.1 * rng.standard_normal(150)
    return _csv(X, y), _csv(rng.standard_normal((25, 3)))


def _train(pkg, path, flags, csv):
    rc, out, err = run(pkg, ["-cmd", "train", "-model", str(path), *flags],
                       csv)
    assert rc == 0, err[-2000:]
    return out, err


def _assert_same_artifact(got, want, rtol=1e-8):
    a, a_extra = jckpt.load_model(str(got))
    b, b_extra = jckpt.load_model(str(want))
    assert a.family_name == b.family_name
    # the extras by name, each of the same dtype and value
    assert sorted(a_extra) == sorted(b_extra)
    for name in a_extra:
        assert a_extra[name].dtype == b_extra[name].dtype, name
        np.testing.assert_allclose(a_extra[name], b_extra[name], rtol=rtol,
                                   err_msg=name)
    # by field name; a combinator's by the dotted names of its terms'
    fields = [{**arrays, **static} for arrays, static in (
        jckpt._params_to_arrays(art.kernel_params) for art in (a, b))]
    assert list(fields[0]) == list(fields[1])
    pairs = {name: (fields[0][name], fields[1][name]) for name in fields[0]}
    pairs.update({f: (getattr(a, f), getattr(b, f))
                  for f in ("inducing", "coeffs", "chol_km", "r_mat",
                            "sigma2", "target_mean", "input_means",
                            "input_stddevs")})
    for name, (x, w) in pairs.items():
        if x is None or isinstance(x, int):
            assert x == w, name
            continue
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(x), w, rtol=rtol,
                                   atol=rtol * max(np.abs(w).max(), 1e-300),
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(case, data, tmp_path):
    """The same artifact (1e-8 relative) and the same stdout and stderr as
    the JAX CLI; the JAX artifact serves the same text from both CLIs."""
    csv, test_csv = data
    flags = CASES[case] + BASE
    jout = _train("jax", tmp_path / "jax.npz", flags, csv)
    tout = _train("torch", tmp_path / "torch.npz", flags, csv)
    assert tout == jout
    _assert_same_artifact(tmp_path / "torch.npz", tmp_path / "jax.npz")
    cmd = ["-cmd", "test", "-model", str(tmp_path / "jax.npz"),
           "-with-stddev"]
    assert run("torch", cmd, test_csv) == run("jax", cmd, test_csv)


EXT = ["-kernel", "se_iso", "-n-inducing", "6", "-trainer", "device"]
EXTENSIONS = {
    "student-t": EXT + ["-student-t", "4"],
    "warp": EXT + ["-warp", "2"],
    "pitc": EXT + ["-pitc-block", "16"],
    "warp-se_fat-streaming": SE_FAT + ["-trainer", "device", "-warp", "2",
                                       "-block-size", "64"],
    "exact": ["-exact", "-kernel", "se_iso"],
    "exact-loo": ["-exact", "-loo", "-kernel", "se_iso"],
    "exact-se_fat-restarts": ["-exact", "-dim-red", "2", "-restarts", "2"],
}
# -student-t runs five EM rounds of at least 5 L-BFGS iterations each (109
# evaluations here, the same count in both packages): the two packages'
# roundoff grows to ~4e-8 relative over them
EXTENSION_RTOL = {"student-t": 1e-6}


@pytest.mark.parametrize("case", sorted(EXTENSIONS))
def test_extension_matches_jax(case, data, tmp_path):
    """-student-t, -warp, -pitc-block, -exact and -exact -loo: each CLI
    trains the same artifact (1e-8 relative, the mode's extras included;
    see EXTENSION_RTOL) with the same stdout and stderr, and either
    artifact serves the same text from both CLIs."""
    csv, test_csv = data
    flags = EXTENSIONS[case] + BASE
    jout = _train("jax", tmp_path / "jax.npz", flags, csv)
    tout = _train("torch", tmp_path / "torch.npz", flags, csv)
    assert tout == jout
    _assert_same_artifact(tmp_path / "torch.npz", tmp_path / "jax.npz",
                          rtol=EXTENSION_RTOL.get(case, 1e-8))
    for model in ("jax.npz", "torch.npz"):
        for serve in ([], ["-with-stddev"]):
            cmd = ["-cmd", "test", "-model", str(tmp_path / model), *serve]
            got = run("torch", cmd, test_csv)
            assert got[0] == 0 and got == run("jax", cmd, test_csv)


def test_cosine_matches_jax_from_its_draw(data, tmp_path, monkeypatch):
    """cosine's default frequencies are a random draw, from a torch
    Generator in the port and a JAX key in the JAX package, seeded with the
    same integer: with JAX's draw carried across, the two CLIs train the
    same artifact (1e-8 relative) and print the same text.  One inducing
    point: at cosine's Gram rank, 2, the coefficients cancel and amplify
    rounding in both packages alike."""
    import jax.numpy as jnp

    import gpr_tpu.kernels as jk
    import jax
    from gpr_tpu_torch.kernels import Cosine

    def jax_draw(cls, X, n_inducing, generator=None):
        key = jax.random.PRNGKey(generator.initial_seed())
        jp = jk.Cosine.default_params(jnp.asarray(X.cpu().numpy()),
                                      n_inducing, key)
        return cls(np.array(jp.mu), device=X.device, dtype=X.dtype)

    monkeypatch.setattr(Cosine, "default_params", classmethod(jax_draw))
    csv, test_csv = data
    flags = ["-kernel", "cosine", "-n-inducing", "1"] + BASE
    assert (_train("torch", tmp_path / "torch.npz", flags, csv)
            == _train("jax", tmp_path / "jax.npz", flags, csv))
    _assert_same_artifact(tmp_path / "torch.npz", tmp_path / "jax.npz")
    cmd = ["-cmd", "test", "-model", str(tmp_path / "torch.npz"),
           "-with-stddev"]
    assert run("torch", cmd, test_csv) == run("jax", cmd, test_csv)


def test_tasks_match_jax_from_its_draw(tmp_path, monkeypatch):
    """-tasks 2 -coreg-rank 1 -verbose on rows [x0, x1, task id]: the ICM
    model's task factor W is a random draw, from a torch Generator in the
    port and a JAX key in the JAX package, seeded with the same integer;
    with JAX's draw carried across, the two CLIs train the same artifact
    (1e-8 relative), print the same B and correlations, and serve the same
    text."""
    import jax
    import jax.numpy as jnp

    import gpr_tpu.kernels as jk
    from gpr_tpu_torch import kernels as tk
    from gpr_tpu_torch.convert import from_jax_params

    icm = tk.icm_family(tk.SeIso, 2, 2, 1)

    def jax_draw(cls, X, n_inducing, generator=None):
        jp = jk.icm_family(jk.SeIso, 2, 2, 1).default_params(
            jnp.asarray(X.cpu().numpy()), n_inducing,
            jax.random.PRNGKey(generator.initial_seed()))
        arrays, static = jckpt._params_to_arrays(jp)
        return from_jax_params({**arrays, **static}, np.zeros((1, 3)), 1.0,
                               device=X.device, dtype=X.dtype,
                               family=cls)[0]

    monkeypatch.setattr(icm, "default_params", classmethod(jax_draw))
    rng = np.random.default_rng(3)
    X = rng.standard_normal((120, 2))
    task = np.arange(120) % 2
    y = np.sin(2.0 * X[:, 0]) * (1.0 + task) + 0.1 * rng.standard_normal(120)
    csv = _csv(np.column_stack([X, task]), y)
    test_csv = _csv(np.column_stack([rng.standard_normal((25, 2)),
                                     np.arange(25) % 2]))
    flags = ["-kernel", "se_iso", "-tasks", "2", "-coreg-rank", "1",
             "-n-inducing", "6", "-verbose"] + BASE

    def coregionalization(err):
        return err[err.index("coregionalization B"):]

    tout, terr = _train("torch", tmp_path / "torch.npz", flags, csv)
    jout, jerr = _train("jax", tmp_path / "jax.npz", flags, csv)
    assert tout == jout == ""
    assert coregionalization(terr) == coregionalization(jerr)
    assert len(coregionalization(terr).splitlines()) == 6  # 2 x 2 B and C
    _assert_same_artifact(tmp_path / "torch.npz", tmp_path / "jax.npz")
    art, _ = jckpt.load_model(str(tmp_path / "torch.npz"))
    assert art.family_name == icm.name
    assert (art.input_means[-1], art.input_stddevs[-1]) == (0.0, 1.0)
    cmd = ["-cmd", "test", "-model", str(tmp_path / "torch.npz"),
           "-with-stddev"]
    assert run("torch", cmd, test_csv) == run("jax", cmd, test_csv)


FAMILY_NAMES = ["se_ard", "matern32", "matern52", "rq", "periodic",
                "cosine", "lin_one", "lin_ard", "const"]


@pytest.mark.parametrize("name", FAMILY_NAMES)
def test_every_family_trains_and_serves(name, data, tmp_path):
    """-cmd train -kernel NAME trains every base family (the device trainer
    streaming), and its artifact serves the same text from either
    package."""
    csv, test_csv = data
    model = tmp_path / "m.npz"
    _train("torch", model, ["-kernel", name, "-n-inducing", "3",
                            "-trainer", "device", "-block-size", "64",
                            "-inducing-init", "first", "-seed", "0",
                            "-max-iter", "3"], csv)
    art, _ = jckpt.load_model(str(model))
    assert art.family_name == name
    cmd = ["-cmd", "test", "-model", str(model), "-with-stddev"]
    got = run("torch", cmd, test_csv)
    assert got[0] == 0 and len(got[1].splitlines()) == 25
    assert got == run("jax", cmd, test_csv)


@pytest.mark.parametrize("serve", [[], ["-with-stddev"],
                                   ["-with-stddev", "-predictive"]],
                         ids=["means", "stddev", "predictive"])
def test_test_text_crosses_packages(serve, data, tmp_path):
    """-cmd test prints the same text whichever package wrote the artifact
    and whichever serves it."""
    csv, test_csv = data
    for pkg in CLIS:
        _train(pkg, tmp_path / f"{pkg}.npz", SE_FAT + BASE, csv)
    outputs = {(writer, server): run(server, ["-cmd", "test", "-model",
                                              str(tmp_path / f"{writer}.npz"),
                                              *serve], test_csv)
               for writer in CLIS for server in CLIS}
    assert len(set(outputs.values())) == 1, outputs
    rc, out, _ = outputs["torch", "torch"]
    lines = out.splitlines()
    assert rc == 0 and len(lines) == 25
    assert all(len(line.split(",")) == 1 + bool(serve) for line in lines)


@pytest.mark.parametrize("trainer", [[], ["-trainer", "device",
                                          "-block-size", "64"]],
                         ids=["host", "device"])
def test_checkpoint_resume_bit_equal(trainer, data, tmp_path):
    csv, _ = data
    flags = SE_FAT + ["-inducing-init", "first", "-seed", "0"] + trainer
    ckpt = str(tmp_path / "run.ckpt.npz")
    _train("torch", tmp_path / "full.npz", flags + ["-max-iter", "6"], csv)
    _train("torch", tmp_path / "part.npz",
           flags + ["-max-iter", "2", "-checkpoint", ckpt], csv)
    assert os.path.exists(ckpt)
    _train("torch", tmp_path / "resumed.npz",
           flags + ["-max-iter", "6", "-checkpoint", ckpt, "-resume"], csv)
    _assert_same_artifact(tmp_path / "resumed.npz", tmp_path / "full.npz",
                          rtol=0)


BAD = {
    "resume without checkpoint": (["-resume"], None),
    "loo on the host": (["-loo"], None),
    "loo streaming": (["-loo", "-trainer", "device", "-block-size", "8"],
                      None),
    "cg without exact": (["-cg"], None),
    "two extensions": (["-classify", "-poisson", "-trainer", "device"],
                       None),
    "extension on the host": (["-warp", "2"], None),
    "exact streaming": (["-exact", "-block-size", "8"], None),
    "restarts with checkpoint": (["-restarts", "2", "-checkpoint", "c"],
                                 None),
    "devices without sharded": (["-devices", "2"], None),
    "se_fat options on se_iso": (["-kernel", "se_iso", "-dim-red", "2"],
                                 None),
    "se_fat options on matern32": (["-kernel", "matern32", "-multiscale"],
                                   None),
    "amplitude on lin_one": (["-kernel", "lin_one", "-amplitude", "2"],
                             None),
    "amplitude on const": (["-kernel", "const", "-amplitude", "2"], None),
    "amplitude on a sum": (["-kernel", "sum(se_iso,lin_ard)", "-amplitude",
                            "2"], None),
    "amplitude on sm2": (["-kernel", "sm2", "-amplitude", "2"], None),
    "tasks below two": (["-tasks", "1"], None),
    "coreg rank above tasks": (["-tasks", "2", "-coreg-rank", "3"], None),
    "tasks without integer ids": (["-tasks", "2"], None),
    "tasks with kmeans": (["-tasks", "2", "-inducing-init", "kmeans"],
                          "".join(f"{i * 0.1:.1f},{i % 2},{i * 0.2:.1f}\n"
                                  for i in range(20))),
    "student-t nu of two": (["-student-t", "2", "-trainer", "device"],
                            None),
    "student-t with checkpoint": (["-student-t", "4", "-trainer", "device",
                                   "-checkpoint", "c"], None),
    "pitc with polish": (["-pitc-block", "8", "-trainer", "device",
                          "-polish", "10"], None),
    "exact with polish": (["-exact", "-polish", "10"], None),
    "exact with multiscale": (["-exact", "-multiscale"], None),
    "one column": ([], "1.0\n2.0\n"),
    "ragged rows": ([], "1.0,2.0\n1.0\n"),
    "not a number": ([], "1.0,2.0\n1.0,x\n"),
    "no data": ([], "\n"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_bad_input_messages(case, data, tmp_path):
    flags, csv = BAD[case]
    argv = ["-cmd", "train", "-model", str(tmp_path / "m.npz"), *flags]
    got = run("torch", argv, csv or data[0])
    assert got[0] != 0
    assert got == run("jax", argv, csv or data[0])


def test_test_messages(data, tmp_path):
    csv, _ = data
    _train("torch", tmp_path / "m.npz", SE_FAT + BASE, csv)
    for argv, stdin in ((["-model", str(tmp_path / "m.npz")], "1.0,2.0\n"),
                        (["-model", str(tmp_path / "none.npz")], "1,2,3\n")):
        got = run("torch", ["-cmd", "test", *argv], stdin)
        assert got[0] != 0 and got == run("jax", ["-cmd", "test", *argv],
                                          stdin)


NOT_PORTED = {
    "-cg": (["-exact", "-cg"], 10),
    "-trainer sharded": (["-trainer", "sharded"], 13),
    "-devices": (["-trainer", "sharded", "-devices", "2"], 13),
}


@pytest.mark.parametrize("case", sorted(NOT_PORTED))
def test_not_ported_flags(case, tmp_path):
    flags, item = NOT_PORTED[case]
    # a task-id column and integer targets that every flag accepts
    csv = "".join(f"{i * 0.1:.1f},{i % 2},{i % 2 + 1}\n"
                  for i in range(20))
    rc, out, err = run("torch", ["-cmd", "train", "-model",
                                 str(tmp_path / "m.npz"), *flags], csv)
    assert rc == 1 and out == ""
    assert f"queue 1 item {item}" in err and case.split()[-1] in err
    assert not os.path.exists(tmp_path / "m.npz")


def test_extension_artifact_not_served(data, tmp_path):
    """The artifact of the iterative exact GP (-exact -cg)."""
    csv, test_csv = data
    _train("torch", tmp_path / "m.npz", SE_FAT + BASE, csv)
    art, _ = tckpt.load_model(str(tmp_path / "m.npz"))
    tckpt.save_model(str(tmp_path / "p.npz"), art,
                     extra_arrays={"exact_cg": np.asarray(1)})
    rc, out, err = run("torch", ["-cmd", "test", "-model",
                                 str(tmp_path / "p.npz")], test_csv)
    assert rc == 1 and out == "" and "exact_cg" in err and "item 10" in err


def test_no_gpu_no_fallback(monkeypatch, tmp_path):
    """Without GPR_TPU_PLATFORM=cpu the CLI needs the card: it exits rather
    than run on the CPU."""
    monkeypatch.delenv("GPR_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run("torch", ["-cmd", "test", "-model",
                                 str(tmp_path / "m.npz")], "1,2\n")
    assert rc == 1 and out == "" and "GPR_TPU_PLATFORM=cpu" in err


NATIVE = {
    "basic": b"1.0,2.0,3.5\n4,5e-1,-6\n",
    "blank lines and crlf": b"1,2\r\n\r\n3,4\n\n",
    "single": b"7.25\n",
    "ragged": b"1,2\n3\n",
    "not a number": b"1,abc\n",
    "empty": b"",
}


@pytest.mark.parametrize("case", sorted(NATIVE))
def test_native_csv_matches_jax(case, tmp_path):
    """The port's binding == the JAX package's: arrays, or the error with
    its message; the file entry as the buffer one."""
    assert tnative.get_lib() is not None
    path = tmp_path / "d.csv"
    path.write_bytes(NATIVE[case])

    def outcome(mod, how):
        try:
            return np.asarray(how(mod))
        except mod.CsvError as e:
            return (e.code, e.line, str(e))

    for how in (lambda m: m.parse_csv_bytes(NATIVE[case]),
                lambda m: m.load_csv_file(str(path))):
        got, want = outcome(tnative, how), outcome(jnative, how)
        if isinstance(want, tuple):
            assert got == want
        else:
            np.testing.assert_array_equal(got, want)


def test_subprocess_round_trip(data, tmp_path):
    """python -m gpr_tpu_torch.cli across a real process boundary."""
    csv, test_csv = data
    env = {**os.environ, "GPR_TPU_PLATFORM": "cpu"}
    model = str(tmp_path / "m.npz")

    def call(args, stdin):
        return subprocess.run(
            [sys.executable, "-m", "gpr_tpu_torch.cli", *args], input=stdin,
            capture_output=True, text=True, cwd=REPO, env=env, timeout=120)

    res = call(["-cmd", "train", "-model", model, *SE_FAT, *BASE,
                "-verbose"], csv)
    assert res.returncode == 0, res.stderr
    assert "target variance" in res.stderr and "result: " in res.stderr
    res = call(["-cmd", "test", "-model", model, "-with-stddev"], test_csv)
    assert res.returncode == 0, res.stderr
    assert res.stdout == run("torch", ["-cmd", "test", "-model", model,
                                       "-with-stddev"], test_csv)[1]
