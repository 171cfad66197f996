"""Nothing the benchmark loads is of the JAX stack or the JAX package:
top-level module names compared whole, so the program's own
``gpr_tpu_torch`` passes and ``gpr_tpu`` does not."""

import ast
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_sources_import_no_jax(path):
    import harness

    assert not set(_top_level_imports(path)) & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "gpr_tpu_torch" not in set(_top_level_imports(path))


def test_loaded_modules_after_a_run_hold_no_jax():
    """Every benchmark module imported, and a tiny run driven, in a fresh
    process: sys.modules holds no forbidden top-level name."""
    code = (
        "import sys, glob, os\n"
        f"sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
        "import harness, run, calibrate, counts, data, fitloop\n"
        "from reference import gp\n"
        "for n in ('fit', 'serve', 'fit_dp'): harness.driver(n)\n"
        "import json\n"
        "man = harness.load_json(harness.HERE.parent / 'BENCHMARK.json')\n"
        "for m in man['per_layer']: harness.reader(m['name'])\n"
        "args = run.parse(['--workload', 'seiso-1m-m300.train', '--seed',"
        " '7', '--seconds', '0.2'])\n"
        "run.run_cell(man, args, device='cpu', shrink={'config': {'n': 600,"
        " 'm': 6, 'block': 128}})\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
        "print('gpr_tpu_torch' in sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]" and lines[-1] == "True"


def test_forbidden_compares_whole_names(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "gpr_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gpr_tpu.models", object())
    assert harness.forbidden_modules() == ["gpr_tpu.models"]
