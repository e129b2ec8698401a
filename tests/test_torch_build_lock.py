"""The kernel build's file lock (brpc_tpu_torch/tpu/_build.py) across
processes, on the CPU.

Two processes start together on a cold build directory, as the ranks of
a mesh do (``tpu/launch.py``), with a stub in place of nvcc: a script
that logs each compile, sleeps, and builds the source with g++ (a plain
C function, so the library loads with ctypes). Each source must be
compiled once, and both processes must load the whole library and call
into it.
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = textwrap.dedent("""\
    import os, subprocess, sys, time
    args = sys.argv[1:]
    out, src = args[args.index("-o") + 1], args[-1]
    with open(os.environ["STUB_LOG"], "a") as fh:
        fh.write(f"{os.getpid()} {os.path.basename(src)}\\n")
    time.sleep(0.5)
    subprocess.run(["g++", "-shared", "-fPIC", "-x", "c++", src, "-o", out],
                   check=True)
    """)

CHILD = textwrap.dedent("""\
    import sys
    sys.path.insert(0, {repo!r})
    from brpc_tpu_torch.tpu import _build
    _build.CSRC, _build.BUILD_DIR = {csrc!r}, {build!r}
    _build._nvcc = lambda: {stub!r}
    {call}
    """)


def _tree(tmp_path):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for name, value in (("one", 1), ("two", 2)):
        (csrc / f"{name}.cu").write_text(
            f'extern "C" int value() {{ return {value}; }}\n')
    stub = tmp_path / "nvcc_stub"
    stub.write_text(f"#!{sys.executable}\n" + STUB)
    stub.chmod(0o755)
    return str(csrc), str(build), str(stub)


def _race(tmp_path, call):
    csrc, build, stub = _tree(tmp_path)
    log = tmp_path / "compiles.log"
    code = CHILD.format(repo=REPO, csrc=csrc, build=build, stub=stub,
                        call=call)
    env = dict(os.environ, STUB_LOG=str(log))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    compiled = sorted(line.split()[1] for line in
                      log.read_text().splitlines())
    left = sorted(os.listdir(build))
    return outs, compiled, left


def test_two_processes_build_every_source_once(tmp_path):
    outs, compiled, left = _race(tmp_path, "_build.build_all(); "
                                           "print('built')")
    assert outs == ["built\n", "built\n"]
    assert compiled == ["one.cu", "two.cu"]
    assert not [f for f in left if f.endswith(".tmp")]
    assert len([f for f in left if f.endswith(".so")]) == 2


def test_two_processes_load_one_whole_library(tmp_path):
    outs, compiled, _ = _race(
        tmp_path, "print(_build.load('two').value())")
    assert outs == ["2\n", "2\n"]
    assert compiled == ["two.cu"]
