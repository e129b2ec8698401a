"""The port stands alone: brpc_tpu_torch and chip_smoke.py import neither
JAX nor anything of the JAX package (brpc_tpu or brpc_tpu.*)."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "brpc_tpu_torch")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, filenames in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in sorted(filenames)
                if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "brpc_tpu"


def _imports(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_forbidden_matches_exact_module_names():
    assert _forbidden("brpc_tpu") and _forbidden("brpc_tpu.serving.model")
    assert _forbidden("jax.numpy")
    assert not _forbidden("brpc_tpu_torch.serving")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, brpc_tpu_torch.serving, brpc_tpu_torch.tpu.pallas_ops,"
            " brpc_tpu_torch.tpu._build, brpc_tpu_torch.serving.weights,"
            " brpc_tpu_torch.tpu.train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'brpc_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
