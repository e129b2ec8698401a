"""The port's four generators (``brpc_tpu_torch/tools/gen_*.py``) against
what is committed and against the JAX package's generators.

- ``gen_hpack_tables`` (``OUT`` under ``tmp_path``) writes the committed
  port header byte for byte, which equals the JAX package's header from
  ``#pragma once`` on (only the two comment lines that name the
  generator and its source differ).
- ``gen_press_echo_desc`` writes ``tests/data/press_echo.desc``.
- ``gen_rpc_meta_proto.build()`` and ``gen_serving_proto.build()`` equal
  the JAX generators' ``build().SerializeToString()`` (only this test
  imports protobuf), and the module each ``main`` writes under
  ``tmp_path`` imports with no protobuf, has the committed port
  module's ``serialized_pb`` and encodes numpy-seeded values of every
  message to the committed module's bytes.

No test writes into the tree. Tolerance: exact.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

from brpc_tpu_torch.proto import rpc_meta_pb2, serving_pb2
from brpc_tpu_torch.tools import (gen_hpack_tables, gen_press_echo_desc,
                                  gen_rpc_meta_proto, gen_serving_proto)
from tests.test_torch_proto import _apply, _spec_from_rng
from tools import gen_press_echo_desc as jax_press_echo
from tools import gen_rpc_meta_proto as jax_rpc_meta
from tools import gen_serving_proto as jax_serving

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_HEADER = os.path.join(REPO, "brpc_tpu_torch", "native",
                           "hpack_tables.h")
JAX_HEADER = os.path.join(REPO, "brpc_tpu", "native", "hpack_tables.h")
MODULES = [(gen_rpc_meta_proto, jax_rpc_meta, rpc_meta_pb2),
           (gen_serving_proto, jax_serving, serving_pb2)]
IDS = ["rpc_meta", "serving"]


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


def test_hpack_header_is_the_committed_one(tmp_path, monkeypatch, capsys):
    out = tmp_path / "hpack_tables.h"
    monkeypatch.setattr(gen_hpack_tables, "OUT", str(out))
    gen_hpack_tables.main()
    assert "61 static entries, 257 huffman codes" in capsys.readouterr().out
    got = out.read_bytes()
    assert got == _read(PORT_HEADER)
    assert got.startswith(
        b"// Generated by brpc_tpu_torch/tools/gen_hpack_tables.py from\n"
        b"// brpc_tpu_torch/policy/hpack.py ")
    ref = _read(JAX_HEADER)
    assert got[got.index(b"#pragma once"):] == \
        ref[ref.index(b"#pragma once"):]


def test_press_echo_desc_is_the_vendored_set(tmp_path):
    out = tmp_path / "press_echo.desc"
    assert gen_press_echo_desc.main([str(out)]) == 0
    want = _read(os.path.join(REPO, "tests", "data", "press_echo.desc"))
    assert out.read_bytes() == want
    assert gen_press_echo_desc.build() == \
        jax_press_echo.build().SerializeToString()


@pytest.mark.parametrize("gen,jax_gen,committed", MODULES, ids=IDS)
def test_build_is_the_reference_file_descriptor(gen, jax_gen, committed):
    assert gen.build() == jax_gen.build().SerializeToString()


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("gen,jax_gen,committed", MODULES, ids=IDS)
def test_written_module_is_the_committed_modules_tables(gen, jax_gen,
                                                       committed, tmp_path):
    out = tmp_path / "written_pb2.py"
    assert gen.main([str(out)]) == 0
    mod = _load(str(out), f"written_{committed.__name__.split('.')[-1]}")
    assert mod.DESCRIPTOR.serialized_pb == committed.DESCRIPTOR.serialized_pb
    names = list(committed.DESCRIPTOR.message_types_by_name)
    assert list(mod.DESCRIPTOR.message_types_by_name) == names
    assert list(mod.DESCRIPTOR.services_by_name) == \
        list(committed.DESCRIPTOR.services_by_name)
    rng = np.random.default_rng(25)
    for name in names:
        for _ in range(20):
            spec = _spec_from_rng(getattr(committed, name), rng)
            want = _apply(getattr(committed, name)(), spec)
            got = _apply(getattr(mod, name)(), spec)
            assert got.SerializeToString() == want.SerializeToString(), name


@pytest.mark.parametrize("gen,jax_gen,committed", MODULES, ids=IDS)
def test_written_module_imports_without_protobuf(gen, jax_gen, committed,
                                                 tmp_path):
    """A fresh interpreter runs the generator's CLI into ``tmp_path`` and
    imports what it wrote, with no protobuf, JAX or JAX package loaded."""
    out = tmp_path / "written_pb2.py"
    code = (
        "import importlib.util, runpy, sys\n"
        f"sys.argv = ['gen', {str(out)!r}]\n"
        "try:\n"
        f"    runpy.run_module({gen.__name__!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"spec = importlib.util.spec_from_file_location('w', {str(out)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"from {committed.__name__.rsplit('.', 1)[0]} import "
        f"{committed.__name__.rsplit('.', 1)[1]} as c\n"
        "assert mod.DESCRIPTOR.serialized_pb == c.DESCRIPTOR.serialized_pb\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'brpc_tpu', 'tools') or "
        "m.startswith('google.protobuf'))\n"
        "assert not bad, bad\n"
        "print('imported')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith(f"wrote {out} (")
    assert r.stdout.endswith("imported\n")

