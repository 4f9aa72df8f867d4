"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: the program's name, dr3_tpu_torch, begins with the JAX
package's, dr3_tpu."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from perfbench import run

HERE = os.path.join(run.ROOT, "perfbench")


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def sources(root: str):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere_in_the_harness():
    for path in sources(HERE):
        assert not imported_tops(path) & {"jax", "jaxlib", "flax", "dr3_tpu"}, path


def test_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(HERE, "reference")):
        assert not imported_tops(path) & {"jax", "jaxlib", "flax", "dr3_tpu",
                                          "dr3_tpu_torch"}, path


def test_sys_modules_check_compares_whole_names():
    code = ("import sys; from perfbench import run; import dr3_tpu_torch; "
            "assert run.loaded_forbidden() == [], run.loaded_forbidden(); "
            "sys.modules['dr3_tpu.x'] = sys; print(run.loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "['dr3_tpu']"


def test_run_refuses_without_a_card_or_its_program(tmp_path):
    """Without a CUDA card the run prints no result and exits 2; in a
    directory that holds only the benchmark's files it exits non-zero."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    args = ["-m", "perfbench.run", "--workload", "bal-dubrovnik-88", "--seed", "3",
            "--seconds", "1", "--trace", "0"]
    p = subprocess.run([sys.executable, *args], cwd=run.ROOT, capture_output=True, text=True,
                       env=env)
    assert p.returncode == 2 and p.stdout == ""
    import shutil

    shutil.copytree(HERE, tmp_path / "perfbench")
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    p = subprocess.run([sys.executable, *args], cwd=tmp_path, capture_output=True, text=True,
                       env=dict(env, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""
