"""Nothing the harness or the reference loads is the JAX stack or the JAX
package (top-level names compared whole: the port's name begins with the
JAX package's), and the reference loads nothing of the program."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT

PROGRAM = ["super_rag_tpu_torch.engine.batcher", "super_rag_tpu_torch.engine.collection",
           "super_rag_tpu_torch.engine.index", "super_rag_tpu_torch.models.encoder_service",
           "super_rag_tpu_torch.models.hf_loader", "super_rag_tpu_torch.service.rerank_service",
           "super_rag_tpu_torch.ops.hybrid", "super_rag_tpu_torch.ops.dense_topk"]
TOP = "sorted({m.split('.')[0] for m in sys.modules})"


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {ROOT!r})\n"
                          + code + f"\nimport json; print(json.dumps({TOP}))"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_and_the_program_load_no_jax():
    from benchmark import harness

    code = ("import benchmark.harness, benchmark.check, benchmark.system, benchmark.trace\n"
            "from benchmark import registry\n"
            "spec = __import__('json').load(open('BENCHMARK.json'))\n"
            "[registry.metric_reader(m['name']) for m in spec['end_to_end'] + spec['per_layer']]\n"
            + "\n".join(f"import {m}" for m in PROGRAM))
    loaded = set(_loaded(code))
    assert "super_rag_tpu_torch" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    code = ("sys.path.insert(0, 'benchmark')\n"
            "import control\n"
            "from benchmark import data\n"
            "data.CHUNK = 1024\n"
            "sys.path.insert(0, 'benchmark/tests')\n"
            "from conftest import tiny\n"
            "_, n, _ = control.control_run('a10m.batch512', 3, 'cpu', tiny('a10m.batch512'))\n"
            "assert n['dense_err'] > 0, n")
    loaded = set(_loaded(code))
    assert "super_rag_tpu_torch" not in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "super_rag_tpu"}


def test_no_result_from_the_benchmarks_files_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "a10m.batch512",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and out.stdout == ""
    assert json.load(open(tmp_path / "BENCHMARK.json"))["command"] == ["python3", "benchmark/run.py"]
