"""What the benchmark loads: never JAX, Flax or the JAX package; the
reference nothing of the program either. Without the card the benchmark
prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness.common import forbidden_loaded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH_DIR = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _sources(*parts):
    base = os.path.join(BENCH_DIR, *parts)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_the_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["jax.numpy", "numpy"]) == ["jax"]
    assert forbidden_loaded(["flax.linen", "jaxlib.xla_client"]) == [
        "flax", "jaxlib"]
    assert forbidden_loaded(["multimodal_sequencing_tpu.models"]) == [
        "multimodal_sequencing_tpu"]
    assert forbidden_loaded(["multimodal_sequencing_tpu_torch.ops",
                             "jax_like", "torch"]) == []


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    for path in _sources():
        for top, _ in _imports(path):
            assert top not in ("jax", "jaxlib", "flax",
                               "multimodal_sequencing_tpu"), path


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "hashlib", "itertools", "math", "re", "typing",
               "numpy", "torch"}
    for path in _sources("reference"):
        for top, level in _imports(path):
            assert level > 0 or top in allowed, (path, top)


def _bare_checkout(tmp_path):
    """A directory with BENCHMARK.json and the files under `paths` alone."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH_DIR, os.path.join(tmp_path, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "text-train-b192",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_without_a_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(_bare_checkout(tmp_path), env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_with_the_benchmark_files_alone_no_result(tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = _run(_bare_checkout(tmp_path))
    assert out.returncode != 0
    lines = out.stdout.strip().splitlines()
    assert not lines or "correct" not in json.loads(lines[-1])
