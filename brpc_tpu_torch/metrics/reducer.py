"""Reducers — contention-free write-side counters (reference bvar/reducer.h).

The reference's central trick (``reducer.h:193,335,391,493`` + agent_group/
combiner): each writing thread owns a thread-local agent; ``operator<<`` only
touches the agent; reads sweep and combine all agents. Writers never contend
with each other or with readers.

The Python build keeps the exact same architecture — a per-thread agent slot
registered with the reducer, combined on read — because it has the same
payoff under the GIL: the hot path is a single LOAD_FAST + inplace add on an
unshared object, no lock acquisition, and reads don't stall writers.
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Generic, List, TypeVar

T = TypeVar("T")


class _Agent:
    __slots__ = ("value",)

    def __init__(self, identity):
        self.value = identity


class _AgentAnchor:
    """Lives in a thread's TLS; its collection (thread death) retires the
    agent into the reducer's _retired accumulator (the reference folds dying
    agents back through agent_group's thread-exit hook)."""

    __slots__ = ("__weakref__",)


class Reducer(Generic[T]):
    """Combine per-thread values with ``op`` on read.

    op: associative & commutative (add/max/min).
    identity: the op's identity element.
    inverse: optional inverse op enabling Window sampling (add has one,
             max/min don't — mirrors the reference's sampler rules).
    """

    def __init__(self, identity: T, op: Callable[[T, T], T],
                 inverse: Callable[[T, T], T] = None):
        self._identity = identity
        self._op = op
        self._inverse = inverse
        self._tls = threading.local()
        self._agents: List[_Agent] = []
        self._agents_lock = threading.Lock()
        # Combined value of agents belonging to dead threads.
        self._retired = identity

    # -------------------------------------------------------------- hot path
    def _agent(self) -> _Agent:
        agent = getattr(self._tls, "agent", None)
        if agent is None:
            agent = _Agent(self._identity)
            anchor = _AgentAnchor()
            self._tls.agent = agent
            self._tls.anchor = anchor
            with self._agents_lock:
                self._agents.append(agent)
            weakref.finalize(anchor, self._retire_agent, agent)
        return agent

    def _retire_agent(self, agent: _Agent) -> None:
        """Thread died: fold its value into _retired, drop the agent."""
        with self._agents_lock:
            try:
                self._agents.remove(agent)
            except ValueError:
                return
            self._retired = self._op(self._retired, agent.value)

    def put(self, value: T) -> "Reducer[T]":
        agent = self._agent()
        agent.value = self._op(agent.value, value)
        return self

    __lshift__ = put  # adder << 5, like the reference's operator<<

    # ------------------------------------------------------------- read side
    def get_raw_value(self) -> T:
        """Combined value in the op's own domain (no display clamping)."""
        result = self._retired
        with self._agents_lock:
            agents = list(self._agents)
        for agent in agents:
            result = self._op(result, agent.value)
        return result

    def finalize(self, value: T) -> T:
        """Map a raw combined value to the displayed value (identity here;
        Maxer/Miner clamp their +-inf identity to 0)."""
        return value

    def get_value(self) -> T:
        return self.finalize(self.get_raw_value())

    def reset(self) -> T:
        """Atomically read-and-zero (used by window samplers w/o inverse)."""
        with self._agents_lock:
            result = self._retired
            self._retired = self._identity
            for agent in self._agents:
                result = self._op(result, agent.value)
                agent.value = self._identity
        return result

    @property
    def identity(self) -> T:
        return self._identity

    @property
    def has_inverse(self) -> bool:
        return self._inverse is not None

    def inverse(self, a: T, b: T) -> T:
        return self._inverse(a, b)


class Adder(Reducer):
    """bvar::Adder — contention-free sum."""

    # adders only ever accumulate on the write paths that use them here,
    # so the exposition format advertises them as counters, not gauges
    prometheus_type = "counter"

    def __init__(self, name: str = None):
        super().__init__(0, lambda a, b: a + b, lambda a, b: a - b)
        if name:
            self.expose_as(name)

    def put(self, value):
        # specialized hot path: += beats the generic op indirection (this
        # runs several times per RPC on the server dispatch path)
        agent = getattr(self._tls, "agent", None)
        if agent is None:
            agent = self._agent()
        agent.value += value
        return self

    __lshift__ = put

    def expose_as(self, name: str):
        from brpc_tpu_torch.metrics.variable import Variable

        class _Wrap(Variable):
            def __init__(w, reducer):
                super().__init__()
                w._reducer = reducer
                # the exposition type rides the wrapper into the registry
                # (prometheus_text reads it off the exposed object)
                t = getattr(reducer, "prometheus_type", None)
                if t is not None:
                    w.prometheus_type = t

            def get_value(w):
                return w._reducer.get_value()

        self._var = _Wrap(self).expose(name)
        return self


class Maxer(Reducer):
    def __init__(self):
        super().__init__(float("-inf"), max)

    def finalize(self, value):
        return 0 if value == float("-inf") else value


class Miner(Reducer):
    def __init__(self):
        super().__init__(float("inf"), min)

    def finalize(self, value):
        return 0 if value == float("inf") else value
