"""The port's parser fuzzer (``brpc_tpu_torch/tools/fuzz.py``) at a CI
budget, and a differential against the JAX package's (``tools/fuzz.py``).

Each of the 15 port targets runs 3000 mutated cases from seed 0xC0FFEE
with no crash; the two native targets run on the port's engine, which
g++ builds (no skip: a failed build fails the test). The differential
sends the same 2000 mutated cases a target (the port's seeds equal the
JAX package's byte for byte) through both packages' targets, every
target but ``h2_native`` (the JAX engine is another binary), and holds
the outcomes equal: returned, or the name of the declared error raised;
``native_scanner``'s frame tuples as well. A divergence passes only when
a predicate on its bytes matches an entry of ROADMAP.md's Queue 3; today
one: the JAX ``H2Conn`` accepts a SETTINGS INITIAL_WINDOW_SIZE above
2^31-1, which the port answers with ``H2Error`` (FLOW_CONTROL_ERROR).
"""

import random
import socket
import struct

import pytest

from brpc_tpu_torch import native
from brpc_tpu_torch.policy import h2
from brpc_tpu_torch.tools import fuzz
from tools import fuzz as jax_fuzz

ITERS = 3000
DIFF_ITERS = 2000
SEED = 0xC0FFEE
TARGETS = sorted(fuzz._allowed())


@pytest.fixture(scope="module", autouse=True)
def _close_engine():
    yield
    fuzz.close_h2_native()


def test_the_targets_are_the_reference_targets():
    assert TARGETS == sorted(jax_fuzz._allowed())
    assert len(TARGETS) == 15


@pytest.mark.parametrize("target", TARGETS)
def test_fuzz_parser(target):
    assert fuzz.run_target(target, ITERS, seed=SEED) == ITERS


def test_the_engine_answers_after_its_campaign():
    """The h2_native campaign leaves the engine serving: the first seed,
    a valid gRPC conversation, on a fresh connection gets the engine's
    SETTINGS back (a first request that is not gRPC would be detached to
    the Python stack, which this listener does not have)."""
    fuzz.run_target("h2_native", 200, seed=SEED)
    with socket.create_connection(("127.0.0.1", fuzz._h2_native_ctx()[2]),
                                  timeout=5) as s:
        s.sendall(h2.PREFACE + fuzz.seeds_h2_native()[0])
        head = b""
        while len(head) < 9:
            chunk = s.recv(9 - len(head))
            assert chunk, "the engine closed a valid connection"
            head += chunk
    assert head[3] == h2.SETTINGS


def test_main_prints_each_targets_count(capsys):
    assert fuzz.main(["--target", "resp", "--iters", "50"]) == 0
    assert capsys.readouterr().out == "fuzz[resp]: 50 cases ok\n"


def _outcome(fn, allowed, case):
    try:
        fn(case)
    except allowed as e:
        return type(e).__name__
    return "returned"


def _h2_window_above_max(case: bytes) -> bool:
    """ROADMAP Queue 3 (reference fault): a SETTINGS frame that sets
    INITIAL_WINDOW_SIZE above 2^31-1. Walks the frames after the
    preface as the connection would read them."""
    if not case.startswith(h2.PREFACE):
        return False
    pos = len(h2.PREFACE)
    while pos + 9 <= len(case):
        n = int.from_bytes(case[pos:pos + 3], "big")
        ftype, flags = case[pos + 3], case[pos + 4]
        payload = case[pos + 9:pos + 9 + n]
        if ftype == h2.SETTINGS and not flags & h2.FLAG_ACK:
            for i in range(0, len(payload) - 5, 6):
                key, value = struct.unpack_from("!HI", payload, i)
                if (key == h2.S_INITIAL_WINDOW_SIZE
                        and value > h2.MAX_WINDOW):
                    return True
        pos += 9 + n
    return False


# (target, JAX outcome, port outcome, predicate): divergences that
# ROADMAP.md's Queue 3 records
KNOWN = [("h2", "returned", "H2Error", _h2_window_above_max)]


def _known(target, jax_out, port_out, case):
    return any(t == target and (j, p) == (jax_out, port_out) and pred(case)
               for t, j, p, pred in KNOWN)


@pytest.mark.parametrize("target", [t for t in TARGETS if t != "h2_native"])
def test_outcomes_equal_the_jax_targets(target):
    port_fn, port_seeds, port_allowed = fuzz._allowed()[target]
    jax_fn, jax_seeds, jax_allowed = jax_fuzz._allowed()[target]
    seeds = port_seeds()
    assert seeds == jax_seeds()
    if target == "native_scanner":
        from brpc_tpu import native as jax_native

        port_sc = native.FrameScanner(max_frames=32)
        jax_sc = jax_native.FrameScanner(max_frames=32)
        assert jax_sc.available
    mut = fuzz.Mutator(seeds, random.Random(SEED))
    for i in range(DIFF_ITERS):
        case = mut.next_case()
        got = _outcome(port_fn, port_allowed, case)
        want = _outcome(jax_fn, jax_allowed, case)
        assert got == want or _known(target, want, got, case), (
            f"{target} case {i}: JAX {want}, port {got}; "
            f"seed={SEED:#x} hex={case.hex()}")
        if target == "native_scanner":
            assert (port_sc.scan(case, 64 << 20)
                    == jax_sc.scan(case, 64 << 20)), case.hex()


def test_the_known_h2_divergence_and_its_predicate():
    """The one Queue 3 entry, as bytes: the JAX connection takes the
    window, the port's refuses it; the predicate matches it and not the
    same frame at 2^31-1, which both accept."""
    over = h2.PREFACE + h2.pack_settings([(h2.S_INITIAL_WINDOW_SIZE,
                                           0x8000FFFF)])
    at_max = h2.PREFACE + h2.pack_settings([(h2.S_INITIAL_WINDOW_SIZE,
                                             h2.MAX_WINDOW)])
    port_fn, _, port_allowed = fuzz._allowed()["h2"]
    jax_fn, _, jax_allowed = jax_fuzz._allowed()["h2"]
    assert _outcome(jax_fn, jax_allowed, over) == "returned"
    assert _outcome(port_fn, port_allowed, over) == "H2Error"
    assert _known("h2", "returned", "H2Error", over)
    assert not _h2_window_above_max(at_max)
    assert _outcome(port_fn, port_allowed, at_max) == "returned"
    assert _outcome(jax_fn, jax_allowed, at_max) == "returned"
