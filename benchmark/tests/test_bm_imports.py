"""What a benchmark run loads: no ``jax``, ``jaxlib``, ``flax`` or JAX
package ``brpc_tpu`` (top-level names compared whole, so
``brpc_tpu_torch`` is not ``brpc_tpu``), and a reference that loads
nothing of the program."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from benchmark import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _loaded(code: str) -> set:
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240,
        check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_the_program_load_no_jax():
    names = _loaded(
        "import benchmark.run, benchmark.calibrate, benchmark.faults\n"
        "import benchmark.drivers.train\n"
        "from benchmark.registry import Registry\n"
        "r = Registry()\n"
        "[r.metric_reader(m['name']) for m in r.spec['per_layer']]\n"
        "import brpc_tpu_torch.tpu.train")
    assert "brpc_tpu_torch" in names and "benchmark" in names
    assert not names & set(run.BANNED)


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded("import benchmark.reference, benchmark.check, "
                    "benchmark.yardstick, benchmark.devtrace")
    assert not names & {"brpc_tpu_torch", *run.BANNED}


def test_banned_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "brpc_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    for name in run.BANNED:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "brpc_tpu.tpu", sys)
    assert run.banned_modules() == ["brpc_tpu"]


def test_without_a_card_a_run_exits_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pythia-1.4b.train.s8192", "--seed", str(2 ** 32 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("reader, rc", [("import jax", 3), ("", 0)])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, reader, rc):
    """The per-layer readers load while the result line is built: one that
    imports ``jax`` (a stub here) leaves the run with exit 3 and no
    result; the same reader without the import prints the line."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    spec["per_layer"].append({"name": "loads_jax", "unit": "%",
                              "better": "higher", "source": "device_trace",
                              "layer": "device",
                              "moves": "train_tokens_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "metrics" / "loads_jax.py").write_text(
        f"{reader}\n\n\ndef read(ctx):\n    return 50.0\n")
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    (stubs / "jax.py").write_text("")
    cell = spec["workloads"][0]["name"]
    code = textwrap.dedent(f"""
        import sys
        from benchmark import run
        from benchmark.registry import Registry
        reg = Registry()
        w = reg.workload({cell!r})
        trace = {{"busy_s": 1.0, "window_s": 1.0, "kernel_s": {{}},
                  "device_ops": [], "idle_gaps": []}}
        result = {{"trace": trace, "steps": 10, "correct": True,
                   "model": reg.config(w["config"])["model_config"],
                   "attempted": 10, "failed": 0, "check": {{}}}}
        assert not run.banned_modules()
        sys.exit(run.report(reg, {cell!r}, result, True, {{}},
                            reg.traffic(w["traffic"])))
    """)
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{stubs}")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == rc, out.stderr
    if rc:
        assert out.stdout == "" and "jax" in out.stderr.splitlines()[-1]
    else:
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["metrics"]["loads_jax"] == {"value": 50.0, "unit": "%"}
