#!/usr/bin/env python
"""Subinterpreter dispatch probe (VERDICT r4 #2b, on the record).

Could a subinterpreter dispatch pool lift the Python-service lane past
its sync-8 ceiling? This probe measures the cost of dispatching a service
body to a subinterpreter with its own GIL (PEP 684, Python 3.12's
``_xxsubinterpreters``) and back, against running it inline: two pipes
carry a 16-byte request to an echo loop in the subinterpreter and its
answer back.

On one core the answer is structural before it is mechanical: there is
no second core for a second GIL to run on, so any dispatch overhead is
pure loss. On more cores the pool pays only when a service body runs
longer than this overhead. The probe imports neither torch nor anything
else of the port.

Run standalone: python -m brpc_tpu_torch.tools.subinterp_probe
"""

import os
import sys
import threading
import time
import tracemalloc


def probe(n: int = 20000):
    """Returns (µs a dispatch round trip through a subinterpreter,
    µs an inline call of the same body), each over ``n`` calls. Raises
    ``RuntimeError`` while tracemalloc traces: on 3.12 a subinterpreter
    with a GIL of its own then corrupts the allocator's state and the
    process aborts (double free)."""
    import _xxsubinterpreters as si

    if tracemalloc.is_tracing():
        raise RuntimeError("tracemalloc is tracing; a subinterpreter with "
                           "its own GIL would corrupt its tables")
    intp = si.create()
    # channel-free minimal dispatch: run_string with shared os.pipe fds,
    # the cheapest cross-interpreter signal available in 3.12
    r1, w1 = os.pipe()  # main -> sub (request)
    r2, w2 = os.pipe()  # sub -> main (response)
    code = f"""
import os
while True:
    b = os.read({r1}, 16)
    if not b:
        break
    os.write({w2}, b)  # the 'service body': echo
"""
    t = threading.Thread(target=si.run_string, args=(intp, code),
                         name="subinterp-echo", daemon=True)
    t.start()
    payload = b"x" * 16
    # warmup
    for _ in range(100):
        os.write(w1, payload)
        os.read(r2, 16)
    t0 = time.perf_counter()
    for _ in range(n):
        os.write(w1, payload)
        os.read(r2, 16)
    sub_us = (time.perf_counter() - t0) / n * 1e6

    def body(b):
        return b

    t0 = time.perf_counter()
    for _ in range(n):
        body(payload)
    inline_us = (time.perf_counter() - t0) / n * 1e6
    os.close(w1)   # EOF ends the sub's loop; run_string returns
    t.join(timeout=5)
    try:
        si.destroy(intp)
    except Exception:
        pass
    for fd in (r1, r2, w2):
        try:
            os.close(fd)
        except OSError:
            pass
    return sub_us, inline_us


def main():
    cores = os.cpu_count()
    try:
        sub_us, inline_us = probe()
    except Exception as e:
        print(f"# subinterp probe unavailable: {type(e).__name__}: {e}",
              flush=True)
        return 1
    print(f"# subinterp dispatch probe (PEP-684 pool lever, VERDICT r4 "
          f"#2b): {sub_us:.1f} us/dispatch round-trip vs {inline_us:.2f} "
          f"us inline on {cores} core(s) — "
          + ("a pool ADDS this per request with no second core to win it "
             "back; the lever is structurally unavailable here"
             if cores == 1 else
             "pool viability depends on body length vs this overhead"),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
