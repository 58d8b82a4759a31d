"""No module the harness loads is JAX or the JAX package (the check
compares top-level names whole: the port's name begins with the JAX
package's), and the reference side imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from mosaicbench import harness as H

PKG = os.path.join(H.BENCH_DIR, "mosaicbench")
REFERENCE = ("render.py", "score.py", "work.py", "trace.py",
             "reference.py")
PROGRAM = "drone_image_stitch_cpp_tpu_torch"


def test_forbidden_names_compare_whole():
    assert H.forbidden_modules([PROGRAM, f"{PROGRAM}.app", "numpy"]) == []
    assert H.forbidden_modules(["drone_image_stitch_cpp_tpu.ops.warp",
                                "jax._src", "jaxlib", "flax.linen"]) == [
        "drone_image_stitch_cpp_tpu", "flax", "jax", "jaxlib"]
    assert H.forbidden_modules(["jaxtyping", "flaxen"]) == []


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_side_imports_nothing_of_the_program(name):
    tops = {m.split(".")[0] for m in _imports(os.path.join(PKG, name))}
    assert not tops & {PROGRAM, *H.FORBIDDEN}, tops


def test_a_loaded_harness_holds_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from mosaicbench import harness, controls\n"
        "from mosaicbench.kinds import sortie, triage\n"
        "import drone_image_stitch_cpp_tpu_torch.app\n"
        "import drone_image_stitch_cpp_tpu_torch.tools.bench_throughput\n"
        "import drone_image_stitch_cpp_tpu_torch.tools.bench_sortie\n"
        "import drone_image_stitch_cpp_tpu_torch.pipeline.strip\n"
        "for m in harness.load_cell('area-3x20-4k')[4:]:\n"
        "    [harness.reader(x['name']) for x in m]\n"
        "print(harness.forbidden_modules())\n") % (H.ROOT, H.BENCH_DIR)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_the_program_or_a_card_prints_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, or
    on a machine without a card, the command fails and prints nothing on
    standard output."""
    import shutil
    shutil.copy(os.path.join(H.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(H.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "triage-8x4k",
         "--seed", str(2**40 + 3), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
