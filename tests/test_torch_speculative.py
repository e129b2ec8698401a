"""The port's speculative decoding (brpc_tpu_torch.serving.speculative,
``TinyTransformer.verify_step`` and the engine's ``spec_k`` lane) held
against the JAX package's on the CPU: every case of the reference's
``tests/test_serving_spec.py`` that the single-device port covers.

- The draft lane (host-only): the reference's drafting, acceptance and
  AdaptiveK cases on the port, and numpy-seeded histories and
  draft/accept streams through both packages with equal results.
- The ledger's rollback (``truncate_sequence``), on both ledgers.
- ``verify_step`` against sequential ``decode_step``s on the port, and
  the port's ``verify_step`` against the JAX one on the same weights
  (``serving/weights.py``): tokens equal, pools within atol 1e-5, rtol 0.
- The engine: ``spec_k=4`` commits the tokens of ``spec_k=0`` and of the
  JAX ``spec_k=4`` engine on the base and repetitive schedules, in fewer
  steps, with the armed ledger asserting the (1, 1) step contract; the
  step budget counts draft rows; TokenDelta frames over the port's RPC
  carry the accepted counts; garbage drafts (the misdraft fault) leave
  the tokens equal and no block leaked, and collapse; the collapse rule
  and the accept-rate gauge; the committed spec corpus replayed by
  ``tools/rpc_replay`` against the port's Server.

The ``/serving`` builtin's spec line is read from the port's page, its
fields the JAX page's. Left out, for ROADMAP Queue 1: the sharded
truncate (item 7), the quiesce mark a truncate clears (migration, item
6), and the wall-clock half of
``test_throughput_degrades_gracefully`` (its step-count half is held
below).
"""

import os
import threading
import time
import types

import numpy as np
import pytest

import brpc_tpu_torch.rpc as port_rpc
import brpc_tpu_torch.rpc.stream as port_stream
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu.serving import speculative as jax_spec
from brpc_tpu_torch import fault as port_fault
from brpc_tpu_torch import flags as port_flags
from brpc_tpu_torch.metrics import collector as port_collector
from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving import speculative as spec
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.serving.weights import params_from_jax
from brpc_tpu_torch.tpu.device_lane import step_dispatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_SPEC = os.path.join(REPO, "tests", "data", "serving_corpus_spec")
ATOL = 1e-5

# the reference's schedules: synth prompts (the base corpus shape) and
# repetitive motif prompts (the spec corpus shape, tokens < vocab 64)
BASE_SCHED = [(16, 4), (32, 8), (16, 6), (16, 4), (32, 8), (16, 6)]
_MOTIFS = [[7, 12, 19, 3, 12, 19], [41, 41, 9, 33, 41, 41, 9],
           [50, 5, 60, 5, 50, 5, 60]]
REP_SCHED = [(18, 16, 0), (21, 24, 1), (16, 16, 2), (18, 24, 0)]
SMALL = dict(vocab=64, d_model=16, n_heads=2, n_layers=1)


def _motif_prompt(plen, motif):
    m = _MOTIFS[motif % len(_MOTIFS)]
    return np.asarray((m * (plen // len(m) + 1))[:plen], dtype=np.int32)


def _base_prompts(model):
    return [(model.synth_prompt(p), n) for p, n in BASE_SCHED]


def _rep_prompts(_model=None):
    return [(_motif_prompt(p, m), n) for p, n, m in REP_SCHED]


# ---------------------------------------------------------------- draft lane
def test_longest_ngram_most_recent_occurrence_wins():
    history = [1, 2, 3, 9, 1, 2, 3, 9]
    # trailing 3-gram (2,3,9) last occurred at 1..3: continuation 1, 2
    assert spec.draft_tokens(history, 2) == [1, 2]


def test_shorter_ngram_fallback():
    history = [5, 6, 7, 8, 6]
    # no 3- or 2-gram recurs; trailing 1-gram 6 followed 5: drafts 7, 8
    assert spec.draft_tokens(history, 3) == [7, 8, 6]


def test_no_match_returns_empty():
    assert spec.draft_tokens([1, 2, 3, 4, 5], 4) == []
    assert spec.draft_tokens([1], 4) == []
    assert spec.draft_tokens([1, 1, 1], 0) == []


def test_draft_capped_at_k():
    assert spec.draft_tokens([1, 2, 3, 4, 1, 2], 2) == [3, 4]


def test_accept_longest_prefix():
    a, committed = spec.accept_longest_prefix([5, 6, 7], [5, 6, 9, 8])
    assert a == 2 and committed == [5, 6, 9]
    a, committed = spec.accept_longest_prefix([5, 6, 7], [5, 6, 7, 8])
    assert a == 3 and committed == [5, 6, 7, 8]  # full accept + bonus
    a, committed = spec.accept_longest_prefix([], [4])
    assert a == 0 and committed == [4]  # empty draft = plain decode


@pytest.fixture
def fault_enabled():
    port_flags.set_flag("fault_injection_enabled", True)
    yield
    port_fault.disarm_all()
    port_flags.set_flag("fault_injection_enabled", False)


def test_misdraft_fault_forces_garbage(fault_enabled):
    port_fault.arm("serving.spec.misdraft", mode="always")
    d = spec.draft_tokens([1, 2, 3, 1, 2, 3], 4, vocab=64)
    # the real matcher would draft [1, 2, 3, ...]; the fault replaces it
    # with the deterministic walk off the last token
    assert d == [4, 5, 6, 7]
    port_fault.disarm_all()
    port_fault.arm("serving.spec.misdraft", mode="always", token=9)
    assert spec.draft_tokens([1, 2, 3, 1, 2, 3], 3, vocab=64) == [9, 9, 9]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drafts_and_acceptance_equal_the_jax_lane(seed):
    """numpy-seeded histories over small alphabets (so n-grams recur),
    every k and n-gram bound: the port's drafts and greedy acceptance
    equal the JAX package's."""
    rng = np.random.RandomState(seed)
    hits = 0
    for _ in range(200):
        hist = rng.randint(0, int(rng.randint(2, 6)),
                           size=int(rng.randint(0, 30))).tolist()
        k, n = int(rng.randint(0, 6)), int(rng.randint(1, 4))
        d = spec.draft_tokens(hist, k, n)
        assert d == jax_spec.draft_tokens(hist, k, n)
        hits += bool(d)
        scores = rng.randint(0, 3, size=len(d) + 1).tolist()
        assert spec.accept_longest_prefix(d, scores) == \
            jax_spec.accept_longest_prefix(d, scores)
    assert hits > 50


def test_grows_on_full_accept():
    ctl = spec.AdaptiveK(4)
    ctl.k = 2
    ctl.update(drafted=2, accepted=2)
    assert ctl.k == 3
    ctl.update(drafted=3, accepted=3)
    assert ctl.k == 4
    ctl.update(drafted=4, accepted=4)
    assert ctl.k == 4  # capped


def test_partial_accept_re_aims():
    ctl = spec.AdaptiveK(8)
    ctl.update(drafted=8, accepted=2)
    assert ctl.k == 3
    assert not ctl.collapsed


def test_collapse_after_zero_streak():
    ctl = spec.AdaptiveK(4, collapse_after=4)
    ks = []
    for _ in range(4):
        ctl.update(drafted=max(1, ctl.k), accepted=0)
        ks.append(ctl.k)
    assert ks == [2, 1, 1, 0]
    assert ctl.collapsed
    # collapsed is terminal: empty drafts never resurrect k
    ctl.update(drafted=0, accepted=0)
    assert ctl.k == 0


def test_accept_resets_streak():
    ctl = spec.AdaptiveK(4, collapse_after=3)
    ctl.update(drafted=4, accepted=0)
    ctl.update(drafted=2, accepted=0)
    ctl.update(drafted=1, accepted=1)  # full accept for drafted=1
    assert ctl.zero_streak == 0 and not ctl.collapsed


@pytest.mark.parametrize("seed", [0, 1])
def test_adaptive_k_tracks_the_jax_controller(seed):
    rng = np.random.RandomState(seed)
    for _ in range(20):
        k_max, after = int(rng.randint(0, 9)), int(rng.randint(1, 6))
        ours, ref = spec.AdaptiveK(k_max, after), jax_spec.AdaptiveK(
            k_max, after)
        for _ in range(30):
            drafted = int(rng.randint(0, ours.k + 2))
            accepted = int(rng.randint(0, drafted + 1))
            ours.update(drafted, accepted)
            ref.update(drafted, accepted)
            assert (ours.k, ours.zero_streak, ours.collapsed) == \
                (ref.k, ref.zero_streak, ref.collapsed)


def test_spec_stats_snapshot_matches_the_jax_shape():
    ours, ref = spec.SpecStats(), jax_spec.SpecStats()
    for st in (ours, ref):
        st.drafted, st.accepted, st.rejected = 10, 7, 3
        st.bonus, st.spec_steps, st.collapsed_seqs = 2, 4, 1
    assert ours.snapshot() == ref.snapshot()
    assert spec.SpecStats().accept_rate() == 1.0


# ------------------------------------------------------------ KV rollback
def _small_kv(side="port", num_blocks=16, block_size=8):
    if side == "jax":
        kv = JaxKV(JaxKVConfig(block_size=block_size,
                               num_blocks=num_blocks), 1, 8)
    else:
        kv = PagedKVCache(KVCacheConfig(block_size=block_size,
                                        num_blocks=num_blocks), 1, 8,
                          device="cpu")
    kv._check = True
    return kv


@pytest.mark.parametrize("side", ["port", "jax"])
def test_truncate_frees_only_the_tail(side):
    kv = _small_kv(side)
    kv.alloc_sequence(1, 10)          # 2 blocks
    kv.extend_sequence(1, 30)         # 4 blocks (speculative headroom)
    assert kv.used_blocks == 4
    assert kv.truncate_sequence(1, 12) == 2  # back to blocks_for(12)
    assert kv.used_blocks == 2
    assert kv.seq_len(1) == 12
    kv.free_sequence(1)
    kv.assert_idle("after truncate roundtrip")


def test_truncate_noop_when_within_coverage():
    kv = _small_kv()
    kv.alloc_sequence(1, 16)
    assert kv.truncate_sequence(1, 16) == 0
    kv.free_sequence(1)
    kv.assert_idle()


@pytest.mark.parametrize("side", ["port", "jax"])
def test_truncate_respects_shared_refcounts(side):
    # a prefix-cache-style fork shares blocks; rollback on one sequence
    # must not free the other's tail
    kv = _small_kv(side)
    kv.alloc_sequence(1, 24)          # 3 blocks
    kv.fork_sequence(1, 2)            # shared refcount 2
    kv.extend_sequence(2, 40)         # +2 private tail blocks
    assert kv.used_blocks == 5
    assert kv.truncate_sequence(2, 24) == 2  # only the private tail
    assert kv.used_blocks == 3
    assert kv.block_table(1) == kv.block_table(2)
    kv.free_sequence(2)
    assert kv.used_blocks == 3        # still held by seq 1
    kv.free_sequence(1)
    kv.assert_idle("after shared truncate")


def test_truncate_unknown_sequence_raises():
    kv = _small_kv()
    with pytest.raises(KeyError):
        kv.truncate_sequence(77, 8)


# ------------------------------------------------- verify == sequential
def _model_pair(max_context=256, num_blocks=64):
    """The JAX model and the port's, the JAX weights carried across, each
    over an armed pool of block 8."""
    jcfg = JaxModelConfig(max_context=max_context, **SMALL)
    jkv = JaxKV(JaxKVConfig(block_size=8, num_blocks=num_blocks),
                jcfg.n_layers, jcfg.kv_dim)
    cfg = ModelConfig(max_context=max_context, seed=3, **SMALL)
    kv = PagedKVCache(KVCacheConfig(block_size=8, num_blocks=num_blocks),
                      cfg.n_layers, cfg.kv_dim, device="cpu")
    jkv._check = kv._check = True
    jm, tm = JaxModel(jcfg, jkv), TinyTransformer(cfg, kv)
    tm.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jm._params.items()}, "cpu"))
    return jm, tm


def test_verify_step_equals_sequential_decode():
    """k+1 rows in ONE verify launch give the argmax stream of k+1
    sequential decode steps: every row's K/V is written before any row
    gathers, and the causal mask keeps row j inside its own prefix."""
    _, model = _model_pair(max_context=128)
    kv = model.kv
    prompt = model.synth_prompt(16)
    k = 4
    # reference: prefill + k+1 sequential decode steps
    t = kv.alloc_sequence(1, len(prompt) + 1)
    seq_tokens = [model.prefill(prompt, t)]
    for _ in range(k + 1):
        ctx = len(prompt) + len(seq_tokens)
        table = kv.extend_sequence(1, ctx)
        out = model.decode_step(np.asarray([seq_tokens[-1]], np.int32),
                                np.asarray([ctx - 1], np.int32), [table])
        seq_tokens.append(int(out[0]))
    kv.free_sequence(1)
    # speculative: one verify launch over a perfect draft
    t = kv.alloc_sequence(2, len(prompt) + 1)
    first = model.prefill(prompt, t)
    assert first == seq_tokens[0]
    ctx = len(prompt) + 1
    table = kv.extend_sequence(2, ctx + k)
    before = step_dispatch.snapshot()
    outs = model.verify_step([first], [ctx - 1], [table],
                             [seq_tokens[1:k + 1]])
    launches, _, syncs = step_dispatch.delta(before,
                                             step_dispatch.snapshot())
    assert (launches, syncs) == (1, 1)
    assert [int(x) for x in outs[0]] == seq_tokens[1:k + 2], (
        "verify argmax diverged from sequential decode")
    kv.free_sequence(2)
    kv.assert_idle("verify-vs-sequential teardown")


@pytest.mark.parametrize("seed", [0, 1])
def test_verify_step_equals_the_jax_verify(seed):
    """Three sequences of numpy-seeded prompts, prefilled on both
    packages, then one verify launch each with numpy-seeded drafts of
    lengths 0..4: the argmax rows equal the JAX ``verify_step``'s, and the
    pools agree within atol 1e-5 (block 0, the padded rows' scratch
    target, left out)."""
    jm, tm = _model_pair()
    rng = np.random.RandomState(seed)
    plens = [int(p) for p in rng.randint(5, 40, size=3)]
    prompts = [rng.randint(1, 64, size=p).astype(np.int32) for p in plens]
    drafts = [rng.randint(0, 64, size=int(n)).tolist()
              for n in rng.choice(5, size=3, replace=False)]
    got = {}
    for side, m in (("jax", jm), ("port", tm)):
        firsts, tables = [], []
        for i, p in enumerate(prompts, start=1):
            firsts.append(m.prefill(p, m.kv.alloc_sequence(i, len(p))))
            tables.append(m.kv.extend_sequence(
                i, len(p) + 1 + len(drafts[i - 1])))
        outs = m.verify_step(firsts, [len(p) for p in prompts], tables,
                             drafts)
        got[side] = (firsts, [list(map(int, o)) for o in outs])
    assert got["port"] == got["jax"]
    assert [len(o) for o in got["port"][1]] == [len(d) + 1 for d in drafts]
    for jp, tp in ((jm.kv.k_pool, tm.kv.k_pool), (jm.kv.v_pool,
                                                   tm.kv.v_pool)):
        np.testing.assert_allclose(tp[:, 8:].numpy(), np.asarray(jp)[:, 8:],
                                   atol=ATOL, rtol=0)
    for m in (jm, tm):
        for i in (1, 2, 3):
            m.kv.free_sequence(i)
        m.kv.assert_idle()


# -------------------------------------------------------- engine lanes
def _engine(model, spec_k, jax=False):
    cls, cfg = (JaxEngine, JaxEngineConfig) if jax else (ServingEngine,
                                                         EngineConfig)
    return cls(model, model.kv, cfg(max_batch=4, token_budget=128,
                                    idle_wait_s=0.005, spec_k=spec_k),
               prefix_cache=False).start()


def _run(engine, requests, stream_ids=None):
    """Submit every (prompt, max_new) under the engine's lock (admission
    sees them at once, so step counts are comparable); wait for all."""
    evs, boxes = [], []
    with engine._cv:
        for i, (prompt, max_new) in enumerate(requests):
            ev, box = threading.Event(), {}
            code, _ = engine.submit(
                np.asarray(prompt, dtype=np.int32), max_new,
                stream_id=stream_ids[i] if stream_ids else 0,
                done=lambda r, b=box, e=ev: (b.update(r=r), e.set()))
            assert code == 0, f"submit rejected: {code}"
            evs.append(ev)
            boxes.append(box)
    for ev in evs:
        assert ev.wait(180), "generation timed out"
    return [list(b["r"].tokens) for b in boxes]


@pytest.fixture(scope="module")
def lanes():
    """Baseline (spec_k=0) and speculative (spec_k=4) port engines over
    models holding the JAX weights, and the JAX spec_k=4 engine, each
    with an armed ledger (the (1, 1) step audit) and no prefix cache."""
    jm, tm0 = _model_pair()
    _, tm4 = _model_pair()
    out = types.SimpleNamespace(base=_engine(tm0, 0), sp=_engine(tm4, 4),
                                jax=_engine(jm, 4, jax=True))
    yield out
    for eng in (out.base, out.sp, out.jax):
        eng.stop()
        eng.kv.assert_idle("spec lanes teardown")
        eng.model.close()


@pytest.mark.parametrize("sched", ["base", "rep"])
def test_spec_tokens_equal_plain_and_the_jax_spec_lane(lanes, sched):
    """The speculative oracle: spec_k=4 commits the tokens of spec_k=0
    and of the JAX spec_k=4 engine, list for list; every launch of the
    run kept the (1, 1) contract (a violation fails the step's
    sequences), and rollback leaked nothing."""
    reqs = (_base_prompts if sched == "base" else _rep_prompts)(
        lanes.sp.model)
    base = _run(lanes.base, reqs)
    before = step_dispatch.snapshot()
    s0 = lanes.sp.steps
    sp = _run(lanes.sp, reqs)
    launches, _, syncs = step_dispatch.delta(before,
                                             step_dispatch.snapshot())
    assert sp == base
    assert sp == _run(lanes.jax, reqs)
    assert [len(t) for t in sp] == [n for _, n in reqs]
    # one launch and one sync per prefill and per step's verify
    assert launches == syncs == len(reqs) + lanes.sp.steps - s0
    assert lanes.sp.kv.used_blocks == 0


def test_repetitive_schedule_takes_fewer_steps(lanes):
    """Prompt lookup hits on repetitive traffic, so the speculative lane
    commits several tokens a step: fewer steps than the plain lane and
    than the JAX spec lane takes no fewer (same schedule, same drafts)."""
    reqs = _rep_prompts()
    counts = {}
    for name in ("base", "sp", "jax"):
        eng = getattr(lanes, name)
        s0 = eng.steps
        _run(eng, reqs)
        counts[name] = eng.steps - s0
    assert counts["sp"] < counts["base"], counts
    assert counts["sp"] == counts["jax"], counts
    st = lanes.sp.spec_stats
    assert st is not None and st.accepted > 0


def test_snapshot_and_gauges_surface(lanes):
    _run(lanes.sp, _rep_prompts())
    snap = lanes.sp.snapshot()["spec"]
    assert snap is not None and snap["k_max"] == 4
    assert snap["drafted"] >= snap["accepted"] >= 0
    assert 0.0 <= snap["accept_rate"] <= 1.0
    assert lanes.base.snapshot()["spec"] is None
    assert spec.accept_rate() >= 0.0  # the passive gauge computes


def _keys(line):
    """A page line's field names, its values dropped."""
    return [w.split("=")[0] for w in line.split() if "=" in w]


def test_serving_builtin_renders_spec_line(lanes):
    """The reference's ``/serving`` case on the port's page: the spec
    line in the text view, with the JAX page's fields, and in the JSON
    view the speculative lane's section, with the JAX lane's keys, and
    none for the plain lane."""
    import json

    from brpc_tpu.builtin.services import serving_service as jax_page
    from brpc_tpu_torch.builtin.services import serving_service

    _run(lanes.sp, _rep_prompts())
    _run(lanes.jax, _rep_prompts())
    status, _ctype, text = serving_service(
        None, types.SimpleNamespace(query={}, path="/serving"))
    assert status == 200
    assert "spec: k_max=4" in text
    assert "accept_rate=" in text and "collapsed_seqs=" in text
    status, _ctype, body = serving_service(
        None, types.SimpleNamespace(query={"format": "json"},
                                    path="/serving"))
    assert status == 200
    snaps = json.loads(body)["engines"]
    specs = [e["spec"] for e in snaps if e.get("spec")]
    assert any(s["k_max"] == 4 and s["drafted"] > 0 for s in specs)
    # the non-speculative lane advertises no spec section at all
    assert any(e.get("spec") is None for e in snaps)
    _, _, jtext = jax_page(None, types.SimpleNamespace(query={},
                                                       path="/serving"))
    _, _, jbody = jax_page(None, types.SimpleNamespace(
        query={"format": "json"}, path="/serving"))
    jspecs = [e["spec"] for e in json.loads(jbody)["engines"]
              if e.get("spec")]

    def spec_line(page):
        return next(line for line in page.splitlines()
                    if line.strip().startswith("spec:"))

    assert _keys(spec_line(text)) == _keys(spec_line(jtext))
    assert set(specs[0]) == set(jspecs[0])


def test_token_budget_counts_draft_rows(lanes):
    from brpc_tpu_torch.serving.engine import Sequence

    seq = Sequence(np.zeros(4, dtype=np.int32), 8)
    assert lanes.sp._decode_cost(seq) == 5  # 1 + spec_k before a step
    seq.spec = spec.AdaptiveK(4)
    seq.spec.k = 2
    assert lanes.sp._decode_cost(seq) == 3
    seq.spec.k = 0                    # collapsed: plain decode cost
    assert lanes.sp._decode_cost(seq) == 1
    assert lanes.base._decode_cost(seq) == 1


def test_engine_config_refuses_negative_spec_k():
    with pytest.raises(ValueError, match="spec_k"):
        EngineConfig(spec_k=-1)


def test_streaming_frames_carry_accepted_counts(lanes):
    """Streamed Generates over the port's Server and Channel on the
    speculative engine: each response's frames join to its tokens, the
    last one done, no frame claims more accepted tokens than it carries,
    and the frames' accepted counts sum to the drafts the engine
    accepted for the run."""
    server = port_rpc.Server().add_service(LlmServingService(lanes.sp)) \
        .start("127.0.0.1:0")
    try:
        ch = port_rpc.Channel(port_rpc.ChannelOptions(timeout_ms=60000))
        ch.init(str(server.listen_endpoint()))
        stub = port_rpc.Stub(ch, serving_pb2.DESCRIPTOR.services_by_name[
            "LlmService"])
        reqs = _rep_prompts()
        want = _run(lanes.base, reqs)
        a0 = lanes.sp.spec_stats.accepted
        out = [None] * len(reqs)

        def call(i, prompt, max_new):
            frames, last = [], threading.Event()

            def on_received(sid, msgs):
                for raw in msgs:
                    frames.append(serving_pb2.TokenDelta.FromString(raw))
                    if frames[-1].done:
                        last.set()

            sid = port_stream.stream_create(port_stream.StreamOptions(
                on_received=on_received))
            cntl = port_rpc.Controller()
            cntl.stream_id = sid
            resp = stub.Generate(serving_pb2.GenerateRequest(
                prompt_tokens=[int(t) for t in prompt],
                max_new_tokens=max_new), controller=cntl)
            assert last.wait(10), "the last TokenDelta never arrived"
            port_stream.stream_close(sid)
            out[i] = (resp, frames)

        threads = [threading.Thread(target=call, args=(i, p, n))
                   for i, (p, n) in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
            assert not t.is_alive()
    finally:
        server.stop()
        server.join(timeout=2)
    accepted = 0
    for (resp, frames), w in zip(out, want):
        toks = list(resp.tokens)
        assert toks == w
        assert [t for f in frames for t in f.tokens] == toks
        assert frames[-1].done and not any(f.done for f in frames[:-1])
        assert all(f.accepted <= len(f.tokens) for f in frames)
        assert all(len(f.tokens) == 1 for f in frames if not f.accepted)
        accepted += sum(f.accepted for f in frames)
    assert accepted > 0
    assert accepted == lanes.sp.spec_stats.accepted - a0


# -------------------------------------------------------- misdraft chaos
def test_garbage_drafts_terminate_equal_with_no_leaks(lanes, fault_enabled):
    base_out = _run(lanes.base, _rep_prompts())
    st = lanes.sp.spec_stats
    d0, a0, c0 = st.drafted, st.accepted, st.collapsed_seqs
    port_fault.arm("serving.spec.misdraft", mode="always")
    try:
        out = _run(lanes.sp, _rep_prompts())
    finally:
        port_fault.disarm_all()
    # the verifier rejects, the bonus token carries the stream, rollback
    # cleans up: tokens equal even with every draft adversarial
    assert out == base_out
    assert lanes.sp.kv.used_blocks == 0, "misdraft run leaked KV blocks"
    drafted, accepted = st.drafted - d0, st.accepted - a0
    assert drafted > 0
    assert accepted / drafted < 0.2, (accepted, drafted)
    # the collapse guard bounds the waste: each sequence stops drafting
    # after its zero-accept streak (4+2+1+1 rows, plus slack)
    assert drafted <= len(REP_SCHED) * 16, drafted
    assert st.collapsed_seqs > c0


def test_misdraft_lane_needs_no_more_steps_than_tokens(lanes,
                                                       fault_enabled):
    """The step-count half of the reference's graceful-degradation case:
    rejected steps commit exactly the bonus token, so the misdraft lane
    needs no more steps than tokens (plus one admission step a request),
    and its tokens equal the plain lane's."""
    want = _run(lanes.base, _rep_prompts())
    port_fault.arm("serving.spec.misdraft", mode="always")
    s0 = lanes.sp.steps
    try:
        out = _run(lanes.sp, _rep_prompts())
    finally:
        port_fault.disarm_all()
    assert out == want
    tokens_total = sum(n for _, n, _ in REP_SCHED)
    assert lanes.sp.steps - s0 <= tokens_total + len(REP_SCHED)


# -------------------------------------------------- watch rule / gauge
def test_spec_collapse_rule_installed_with_reloadable_bound():
    from brpc_tpu_torch.metrics.watch import (KIND_THRESHOLD, global_watch,
                                              install_default_rules)

    install_default_rules()
    rule = {r.name: r for r in global_watch().rules()}[
        "serving_spec_collapse"]
    assert rule.var == "g_serving_spec_accept_rate"
    assert rule.kind == KIND_THRESHOLD and rule.op == "<"
    assert rule.value_fn is not None
    assert rule.value_fn() == pytest.approx(
        port_flags.get("serving_spec_accept_rate_min"))
    port_flags.set_flag("serving_spec_accept_rate_min", "0.4")
    try:
        assert rule.value_fn() == pytest.approx(0.4)
    finally:
        port_flags.set_flag("serving_spec_accept_rate_min", "0.2")


def test_accept_rate_gauge_windows_and_idles_high():
    spec.reset_rate_window()
    assert spec.accept_rate() == 1.0  # idle engines must not alarm
    spec.note_step(10, 1)
    spec.note_step(10, 1)
    spec.note_step(0, 0)  # a step that drafted nothing is not counted
    assert spec.accept_rate() == pytest.approx(0.1)
    spec.reset_rate_window()


def test_spec_variables_are_exposed():
    from brpc_tpu_torch.metrics import variable

    for name in ("g_serving_spec_draft_tokens",
                 "g_serving_spec_accepted_tokens",
                 "g_serving_spec_rejected_tokens",
                 "g_serving_spec_bonus_tokens",
                 "g_serving_spec_accept_rate"):
        assert variable.get_exposed(name) is not None, name
    points = {p["point"] for p in port_fault.snapshot()}
    assert "serving.spec.misdraft" in points


# ------------------------------------------- corpus replay
def test_spec_corpus_replays_against_the_port_server():
    """The committed repetition-heavy corpus (tools/
    record_serving_corpus_spec.py, recorded at its widths with spec_k=4)
    replayed by tools/rpc_replay against the port's Server over a
    spec_k=4 engine (the prefix cache on, the default): every call
    succeeds with the recorded token counts, drafting hits (accept rate
    > 0), and the replayed server spans carry the engine's phases."""
    from tools import record_serving_corpus_spec as recorder
    from tools import rpc_replay
    from brpc_tpu_torch.trace import span as port_span

    dumps = [f for f in os.listdir(CORPUS_SPEC) if f.endswith(".dump")]
    assert dumps, "committed spec corpus missing"
    saved = {k: port_flags.get(k) for k in
             ("rpcz_sample_ratio", "collector_max_samples_per_second")}
    port_flags.set_flag("rpcz_sample_ratio", "1.0")
    port_flags.set_flag("collector_max_samples_per_second", "0")
    port_collector.global_collector()._deny_until = 0.0
    cfg = ModelConfig(vocab=256, d_model=32, n_heads=2, n_layers=2)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=256),
                      cfg.n_layers, cfg.kv_dim, device="cpu")
    kv._check = True
    engine = ServingEngine(TinyTransformer(cfg, kv), kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.005,
        spec_k=recorder.SPEC_K)).start()
    try:
        port_span.reset_for_test()
        server = port_rpc.Server().add_service(LlmServingService(engine)) \
            .start("127.0.0.1:0")
        try:
            rc = rpc_replay.main([
                "--dump", CORPUS_SPEC,
                "--server", str(server.listen_endpoint()),
                "--rate-mult", "2", "--timeout-ms", "30000",
                "--report-interval", "0"])
            assert rc == 0
            deadline = time.monotonic() + 5.0
            while (len([s for s in port_span.recent_spans(200)
                        if s.kind == port_span.KIND_SERVER])
                   < len(recorder.SCHEDULE)
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            server.stop()
            server.join(timeout=2)
        spans = [s for s in port_span.recent_spans(200)
                 if s.kind == port_span.KIND_SERVER]
        assert len([s for s in spans if "prefill_us" in s.phases
                    and "decode_us" in s.phases]) >= len(recorder.SCHEDULE)
        assert engine.tokens_generated == sum(
            n for _, n, _ in recorder.SCHEDULE)
        st = engine.spec_stats
        assert st.drafted > 0 and st.accept_rate() > 0, st.snapshot()
    finally:
        engine.stop()
        engine.kv.assert_idle("spec corpus replay teardown")
        engine.model.close()
        for k, v in saved.items():
            port_flags.set_flag(k, str(v))
