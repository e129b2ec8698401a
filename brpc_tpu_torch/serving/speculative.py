"""Speculative decoding's draft lane: prompt-lookup drafting, host-side.

The port of ``brpc_tpu/serving/speculative.py``. The serving plane's
per-token cost floor is one decode launch per step. Speculative decoding
(Leviathan et al. 2023) raises tokens/step above 1.0 by *drafting* k
candidate tokens cheaply and then *verifying* all of them in one launch
(``TinyTransformer.verify_step``). With greedy acceptance the committed
stream is token for token the non-speculative lane's.

This module is the draft half and does no device work: prompt-lookup /
n-gram drafting (Saxena 2023) proposes the continuation that followed
the most recent earlier occurrence of the sequence's trailing n-gram,
pure host Python over the committed token history, no weights. It
imports no torch, so drafting can never add a second host sync to the
engine's (1, 1) step contract.

Pieces:

- :func:`draft_tokens`: the matcher. Longest trailing n-gram first
  (``ngram_max`` down to 1), most recent earlier occurrence wins, the k
  tokens that followed it are the draft; empty when nothing matches (the
  step is a plain 1-token decode).
- :class:`AdaptiveK`: per-sequence draft length. Grows k toward
  ``k_max`` while drafts are accepted, halves it on zero-accept steps,
  and collapses to 0 (no more speculation for the sequence) after
  ``collapse_after`` consecutive zero-accept steps, which bounds the
  waste of adversarial drafts.
- :func:`accept_longest_prefix`: greedy acceptance, the longest draft
  prefix agreeing with the verifier's argmax plus the one bonus token
  the verifier produced at the first disagreement (Leviathan's rule at
  temperature 0).
- ``g_serving_spec_*`` variables and :func:`note_step`, feeding the
  ``serving_spec_collapse`` watch rule's accept-rate gauge over a
  sliding window of recent steps.

Fault point ``serving.spec.misdraft`` swaps real drafts for adversarial
garbage (a deterministic vocab walk that greedy verification rejects),
driving the accept rate to ~0 to exercise rollback and the collapse
guard.
"""

from __future__ import annotations

import collections
import threading
from typing import List, Sequence, Tuple

from brpc_tpu_torch import fault as _fault
from brpc_tpu_torch.metrics.reducer import Adder
from brpc_tpu_torch.metrics.status import PassiveStatus

_fault.register("serving.spec.misdraft",
                "replace speculative drafts with adversarial garbage "
                "(token=<fixed token> overrides the vocab walk)")

g_serving_spec_draft_tokens = Adder("g_serving_spec_draft_tokens")
g_serving_spec_accepted_tokens = Adder("g_serving_spec_accepted_tokens")
g_serving_spec_rejected_tokens = Adder("g_serving_spec_rejected_tokens")
g_serving_spec_bonus_tokens = Adder("g_serving_spec_bonus_tokens")

# accept rate over a sliding window of recent engine steps (not
# cumulative: the serving_spec_collapse watch rule needs to see a
# *current* collapse, not one damped by hours of healthy history)
_rate_lock = threading.Lock()
_recent_steps: collections.deque = collections.deque(maxlen=256)


def note_step(drafted: int, accepted: int) -> None:
    """Record one engine step's aggregate draft outcome (all sequences)."""
    if drafted <= 0:
        return
    with _rate_lock:
        _recent_steps.append((int(drafted), int(accepted)))


def accept_rate() -> float:
    """Accepted/drafted over the recent-step window; 1.0 when idle so the
    collapse watch rule stays quiet on engines that aren't speculating."""
    with _rate_lock:
        drafted = sum(d for d, _ in _recent_steps)
        accepted = sum(a for _, a in _recent_steps)
    if drafted <= 0:
        return 1.0
    return accepted / drafted


def reset_rate_window() -> None:
    """Test hook: forget the recent-step window."""
    with _rate_lock:
        _recent_steps.clear()


g_serving_spec_accept_rate = PassiveStatus(accept_rate) \
    .expose("g_serving_spec_accept_rate")
g_serving_spec_accept_rate.prometheus_type = "gauge"


def _lookup(history: Sequence[int], k: int, ngram_max: int) -> List[int]:
    """Most recent earlier occurrence of the trailing n-gram, longest n
    first; returns up to k continuation tokens (possibly fewer near the
    end of history)."""
    h = [int(t) for t in history]
    n_hi = min(ngram_max, len(h) - 1)
    for n in range(n_hi, 0, -1):
        tail = h[-n:]
        for j in range(len(h) - n - 1, -1, -1):
            if h[j:j + n] == tail:
                return h[j + n:j + n + k]
    return []


def draft_tokens(history: Sequence[int], k: int, ngram_max: int = 3,
                 vocab: int = 0) -> List[int]:
    """Draft up to ``k`` tokens for a sequence whose committed history
    (prompt + generated) is ``history``. Host-side only. Returns [] when
    no n-gram matches (the step falls back to plain decode).

    Under the armed ``serving.spec.misdraft`` fault the draft is replaced
    with a deterministic garbage walk of length ``k`` — maximum draft
    spend, ~zero acceptance — regardless of what the matcher found."""
    if k <= 0 or len(history) < 2:
        drafted: List[int] = []
    else:
        drafted = _lookup(history, k, ngram_max)
    params = _fault.hit("serving.spec.misdraft")
    if params is not None and k > 0:
        fixed = params.get("token")
        if fixed is not None:
            return [int(fixed)] * k
        last = int(history[-1]) if len(history) else 0
        mod = int(vocab) if vocab and int(vocab) > 1 else 1 << 30
        # walk away from the last token: greedy cycles repeat it, so a
        # strictly-moving walk is the adversarial worst case
        return [(last + 1 + i) % mod for i in range(k)]
    return drafted


def accept_longest_prefix(draft: Sequence[int],
                          scores: Sequence[int]) -> Tuple[int, List[int]]:
    """Greedy acceptance. ``scores`` is the verifier's argmax at each of
    the k+1 scored positions (m_0 for the last committed token, m_j for
    draft token j). Accept draft tokens while they agree with the argmax
    at the *previous* position; the first disagreeing position's argmax
    is the bonus token. Returns ``(accepted, committed)`` where
    ``committed == scores[:accepted+1]`` — always at least one token, at
    most k+1."""
    a = 0
    while a < len(draft) and int(draft[a]) == int(scores[a]):
        a += 1
    return a, [int(scores[j]) for j in range(a + 1)]


class AdaptiveK:
    """Per-sequence draft length: optimistic start at ``k_max``, grow on
    full accepts, halve on zero-accept steps, collapse to 0 after
    ``collapse_after`` consecutive zero-accept steps. Once collapsed the
    sequence speculates no more (its steps are plain 1-token decodes),
    bounding adversarial-draft overhead; partial accepts re-aim k at the
    observed accept length."""

    def __init__(self, k_max: int, collapse_after: int = 4):
        self.k_max = max(0, int(k_max))
        self.k = self.k_max
        self.collapse_after = max(1, int(collapse_after))
        self.zero_streak = 0
        self.collapsed = False

    def update(self, drafted: int, accepted: int) -> None:
        if drafted <= 0 or self.collapsed:
            return
        if accepted >= drafted:
            self.zero_streak = 0
            self.k = min(self.k + 1, self.k_max)
        elif accepted == 0:
            self.zero_streak += 1
            if self.zero_streak >= self.collapse_after:
                self.k = 0
                self.collapsed = True
            else:
                self.k = max(1, self.k // 2)
        else:
            self.zero_streak = 0
            self.k = max(1, min(self.k_max, accepted + 1))


class SpecStats:
    """Per-engine speculative counters (module vars aggregate the
    process; these keep A/B lanes and /serving snapshots per-engine)."""

    __slots__ = ("drafted", "accepted", "rejected", "bonus", "spec_steps",
                 "collapsed_seqs")

    def __init__(self):
        self.drafted = 0
        self.accepted = 0
        self.rejected = 0
        self.bonus = 0
        self.spec_steps = 0
        self.collapsed_seqs = 0

    def accept_rate(self) -> float:
        return self.accepted / self.drafted if self.drafted else 1.0

    def snapshot(self) -> dict:
        return {
            "drafted": self.drafted,
            "accepted": self.accepted,
            "rejected": self.rejected,
            "bonus": self.bonus,
            "spec_steps": self.spec_steps,
            "collapsed_seqs": self.collapsed_seqs,
            "accept_rate": round(self.accept_rate(), 4),
        }
