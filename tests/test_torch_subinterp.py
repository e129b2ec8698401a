"""The port's ``tools/subinterp_probe`` against the JAX package's: the
probe's two per-call costs, and ``main``'s line in the reference's shape
with rc 0, each from a fresh interpreter that loads no torch, JAX or JAX
package (a pytest worker may carry a tracemalloc another test left on,
under which a subinterpreter aborts the process); and the port's probe
refusing to start while tracemalloc traces (ROADMAP Queue 3: the
reference's aborts)."""

import os
import re
import subprocess
import sys
import tracemalloc

import pytest

from brpc_tpu_torch.tools import subinterp_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(
    r"# subinterp dispatch probe \(PEP-684 pool lever, VERDICT r4 #2b\): "
    r"(\d+\.\d) us/dispatch round-trip vs (\d+\.\d\d) us inline on "
    r"(\d+) core\(s\) — (a pool ADDS this per request with no second core "
    r"to win it back; the lever is structurally unavailable here|pool "
    r"viability depends on body length vs this overhead)\n")
FOREIGN = ("bad = sorted(m for m in sys.modules if m.split('.')[0] in "
           "('torch', 'jax', 'jaxlib', 'brpc_tpu'))\n"
           "print('loaded', bad)\n")


def _fresh(code):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)


def test_probe_returns_two_positive_costs():
    r = _fresh("import sys\n"
               "from brpc_tpu_torch.tools.subinterp_probe import probe\n"
               "sub_us, inline_us = probe(2000)\n"
               "assert isinstance(sub_us, float), sub_us\n"
               "assert isinstance(inline_us, float), inline_us\n"
               "assert sub_us > 0 and inline_us > 0, (sub_us, inline_us)\n"
               + FOREIGN)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout == "loaded []\n"


def _main(module):
    return _fresh(f"import runpy, sys\n"
                  f"rc = 0\n"
                  f"try:\n"
                  f"    runpy.run_module({module!r}, run_name='__main__')\n"
                  f"except SystemExit as e:\n"
                  f"    rc = e.code\n"
                  + FOREIGN + "sys.exit(rc)\n")


def test_main_prints_the_reference_line():
    port, ref = _main("brpc_tpu_torch.tools.subinterp_probe"), \
        _main("tools.subinterp_probe")
    assert port.returncode == 0 == ref.returncode, port.stderr + ref.stderr
    line, loaded = port.stdout.rsplit("loaded", 1)
    assert loaded.strip() == "[]"
    got, want = LINE.fullmatch(line), LINE.fullmatch(
        ref.stdout.rsplit("loaded", 1)[0])
    assert got and want, (port.stdout, ref.stdout)
    assert got.group(3, 4) == want.group(3, 4) == (
        str(os.cpu_count()), want.group(4))


def test_a_tracing_process_is_refused_before_any_subinterpreter(capsys):
    started = not tracemalloc.is_tracing()
    if started:
        tracemalloc.start(16)  # as the heap page leaves it
    try:
        with pytest.raises(RuntimeError, match="tracemalloc is tracing"):
            subinterp_probe.probe(10)
        assert subinterp_probe.main() == 1
    finally:
        if started:
            tracemalloc.stop()
    assert capsys.readouterr().out.startswith(
        "# subinterp probe unavailable: RuntimeError: tracemalloc is "
        "tracing")
