"""Nothing in slam_bench/ imports JAX or the JAX package, top-level names
compared whole (the port's name begins with the JAX package's), and the
yardstick (reference, check, generator, roofline, stats) imports nothing
of the port."""

import ast
import sys

from benchtree import BENCH
from slam_bench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "lio_slam_tpu"}
YARDSTICK = ("reference.py", "check.py", "generator.py", "roofline.py",
             "stats.py", "trace.py")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f


def test_the_yardstick_imports_nothing_of_the_port():
    for name in YARDSTICK:
        assert "lio_slam_tpu_torch" not in _imports(BENCH / name), name


def test_the_run_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lio_slam_tpu_torch_fake", sys)
    assert "lio_slam_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lio_slam_tpu.fake", sys)
    assert harness.forbidden_modules() == ["lio_slam_tpu"]
