"""A guard against a tracemalloc left on by an earlier test on the same
xdist worker, for the port's test modules that import its fixtures.

``tests/test_profiling.py::TestProfiling::test_heap_snapshot_and_growth``
(the JAX package's, not edited) fetches ``/hotspots/heap``, which starts
``tracemalloc.start(16)`` and never stops it (ROADMAP Queue 3). Every
later test on that worker then runs several times slower: one ring case
of ``test_torch_mesh_ranks.py`` took 96.6 s against 17.2 s, and a
corpus replay against a JAX engine ran past its 60 s call deadlines.
A module that does
``from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)``
stops such a leak before its module-scoped fixtures and before each of
its tests. Nothing is traced on purpose by those modules.
"""

import tracemalloc

import pytest


def stop_leaked_tracemalloc():
    if tracemalloc.is_tracing():
        tracemalloc.stop()


@pytest.fixture(scope="module", autouse=True)
def no_leaked_tracemalloc_in_module():
    stop_leaked_tracemalloc()


@pytest.fixture(autouse=True)
def no_leaked_tracemalloc():
    stop_leaked_tracemalloc()


def test_a_leaked_tracemalloc_is_stopped():
    """What the fixtures call stops a tracing left on, as the heap page
    leaves it (16 frames), and leaves a stopped one stopped."""
    tracemalloc.start(16)
    stop_leaked_tracemalloc()
    assert not tracemalloc.is_tracing()
    stop_leaked_tracemalloc()
    assert not tracemalloc.is_tracing()
