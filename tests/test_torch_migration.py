"""Disaggregated prefill/decode on the port: KV block-chain migration over
the record lane (brpc_tpu_torch/serving/migration.py), held against the
JAX package's (brpc_tpu/serving/migration.py) on the CPU.

Every single-pool case of tests/test_serving_migration.py runs here
between two port engines (``device="cpu"``, plain attention) behind the
port's Server: the ledger's migration surface, the manifest checks, the
disaggregated plane end to end (the corpus schedule's tokens equal a
co-located engine's, the decode engine prefills 0 tokens), and the chaos
cases (the drop fault falls back to local decode, the stall fault only
delays, shard death drains onto a survivor), and the ``/serving`` page's
migrate lines. Both armed pools are idle
after every case. Beside them, against the JAX package on the same
calls and numpy-seeded pools:

- the ledger's verdicts and records (tables, lengths, refcounts, which
  call raised what) equal the JAX ledger's;
- ``read_chain_blocks`` gives the JAX function's bytes, and
  ``write_chain_blocks`` leaves the JAX function's pools, exactly;
- the corpus schedule disaggregated on the port gives the JAX co-located
  engine's greedy tokens exactly.

Tolerance: none. Tokens and block bytes must be equal (both sides fp32,
plain attention; the migrated bytes are copied, never recomputed).
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu.serving import migration as jax_migration
from brpc_tpu_torch import fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import Server, errors
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, TinyTransformer)
from brpc_tpu_torch.serving.migration import (KVMigrator, MigrationReceiver,
                                              chain_block_bytes,
                                              g_serving_migrate_failed,
                                              g_serving_migrate_seqs,
                                              read_chain_blocks,
                                              write_chain_blocks)
from brpc_tpu_torch.serving.service import LlmServingService
# the committed replay corpus's schedule (synth prompts, greedy decode)
from tools.record_serving_corpus import SCHEDULE

CFG = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)


def _kv(num_blocks=128, block_size=16, layers=2, kv_dim=16):
    kv = PagedKVCache(KVCacheConfig(block_size=block_size,
                                    num_blocks=num_blocks),
                      layers, kv_dim, device="cpu")
    kv._check = True  # armed ledger: audit every mutation
    return kv


def _build_engine(role="both", num_blocks=128):
    cfg = ModelConfig(**CFG)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=num_blocks),
                      cfg.n_layers, cfg.kv_dim, device="cpu")
    kv._check = True
    model = TinyTransformer(cfg, kv)
    engine = ServingEngine(model, kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002, role=role),
        prefix_cache=False).start()
    return engine, kv, model


def _teardown(engine, kv, model):
    engine.stop()
    kv.assert_idle()
    model.close()


def _submit(engine, prompt, max_new, resume=0, cntl=None):
    ev = threading.Event()
    box = {}
    code, seq = engine.submit(
        prompt, max_new, cntl=cntl,
        done=lambda r, box=box, ev=ev: (box.update(r=r), ev.set()),
        resume_seq_id=resume)
    return code, seq, ev, box


def _colocated(plens_news):
    """Greedy tokens of a co-located port engine, one request at a time."""
    engine, kv, model = _build_engine()
    try:
        out = []
        for plen, max_new in plens_news:
            code, seq, ev, _ = _submit(engine, model.synth_prompt(plen),
                                       max_new)
            assert code == 0
            assert ev.wait(300), "reference run stalled"
            out.append(list(seq.out_tokens))
        return out
    finally:
        _teardown(engine, kv, model)


def _jax_colocated(plens_news):
    """The JAX co-located engine's tokens on the same requests."""
    cfg = JaxModelConfig(attn="reference", **CFG)
    kv = JaxKV(JaxKVConfig(block_size=16, num_blocks=128), cfg.n_layers,
               cfg.kv_dim)
    kv._check = True
    model = JaxModel(cfg, kv)
    engine = JaxEngine(model, kv, JaxEngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002),
        prefix_cache=False).start()
    try:
        out = []
        for plen, max_new in plens_news:
            ev = threading.Event()
            code, seq = engine.submit(model.synth_prompt(plen), max_new,
                                      done=lambda r, ev=ev: ev.set())
            assert code == 0
            assert ev.wait(300), "JAX reference run stalled"
            out.append([int(t) for t in seq.out_tokens])
        return out
    finally:
        engine.stop()
        kv.assert_idle()
        model.close()


def _resume(dec, handoff):
    code, _seq, ev, box = _submit(dec, np.zeros(0, dtype=np.int32), 0,
                                  resume=handoff.seq_id)
    assert code == 0
    assert ev.wait(300), "decode stage stalled"
    return box["r"]


@pytest.fixture
def fault_enabled():
    _flags.set_flag("fault_injection_enabled", True)
    yield
    fault.disarm_all()
    _flags.set_flag("fault_injection_enabled", False)


# ------------------------------------------------- ledger migration surface
class TestLedgerMigrationSurface:
    def test_quiesce_export_release_roundtrip(self):
        kv = _kv()
        t = kv.alloc_sequence(1, 40)  # 3 blocks
        assert kv.quiesce_sequence(1) == 40
        table, ntokens = kv.export_chain(1)
        assert list(table) == list(t) and ntokens == 40
        assert kv.release_exported(1) == 3
        kv.assert_idle("after release_exported")

    def test_export_without_quiesce_refused(self):
        kv = _kv()
        kv.alloc_sequence(1, 16)
        with pytest.raises(AssertionError, match="without quiesce"):
            kv.export_chain(1)
        kv.free_sequence(1)
        kv.assert_idle()

    def test_write_clears_the_quiesce_mark(self):
        kv = _kv()
        kv.alloc_sequence(1, 16)
        kv.quiesce_sequence(1)
        kv.extend_sequence(1, 17)
        with pytest.raises(AssertionError, match="without quiesce"):
            kv.export_chain(1)
        kv.unquiesce_sequence(1)
        kv.free_sequence(1)
        kv.assert_idle()

    def test_unquiesce_restores_local_fallback(self):
        kv = _kv()
        kv.alloc_sequence(1, 16)
        kv.quiesce_sequence(1)
        kv.unquiesce_sequence(1)
        with pytest.raises(AssertionError):
            kv.export_chain(1)  # the gate is re-armed: not exportable
        kv.extend_sequence(1, 32)  # and the chain still grows locally
        kv.free_sequence(1)
        kv.assert_idle()

    def test_staging_adopt_handoff_keeps_single_ownership(self):
        """The receiver's choreography: the staging id owns the blocks
        through the transfer, adoption takes them to 2, freeing the
        staging id leaves the destination sequence the only owner."""
        kv = _kv()
        staging = -(1 + 1)
        t = kv.alloc_sequence(staging, 40)
        for b in t:
            assert kv.block_ref(b) == 1
        kv.adopt_sequence(7, t, 40)
        for b in t:
            assert kv.block_ref(b) == 2
        kv.free_sequence(staging)
        for b in t:
            assert kv.block_ref(b) == 1
        assert list(kv.block_table(7)) == list(t)
        kv.extend_sequence(7, 41)  # the adopted chain decodes as usual
        kv.free_sequence(7)
        kv.assert_idle("after staging handoff")

    def test_chain_bytes_roundtrip_through_pools(self):
        """read_chain_blocks then write_chain_blocks is the identity on
        the chain's slots."""
        src = _kv()
        dst = _kv()
        t = src.alloc_sequence(1, 40)
        bb = chain_block_bytes(src)
        assert bb == chain_block_bytes(dst)
        for i, b in enumerate(t):
            sl = slice(b * src.block_size, (b + 1) * src.block_size)
            src.k_pool[:, sl, :] = float(i + 1)
            src.v_pool[:, sl, :] = -float(i + 1)
        payloads = read_chain_blocks(src, t, bb)
        assert len(payloads) == 3 and all(len(p) == bb for p in payloads)
        st = dst.alloc_sequence(-2, 40)
        write_chain_blocks(dst, st, payloads, 40)
        for i, b in enumerate(st):
            sl = slice(b * dst.block_size, (b + 1) * dst.block_size)
            assert bool((dst.k_pool[:, sl, :] == float(i + 1)).all())
            assert bool((dst.v_pool[:, sl, :] == -float(i + 1)).all())
        src.free_sequence(1)
        dst.free_sequence(-2)
        src.assert_idle()
        dst.assert_idle()

    def test_truncate_discards_quiesce_mark(self):
        """tests/test_serving_spec.py::TestTruncateRollback::
        test_truncate_discards_quiesce_mark on the port's ledger."""
        kv = PagedKVCache(KVCacheConfig(block_size=8, num_blocks=16), 1, 8,
                          device="cpu")
        kv._check = True
        kv.alloc_sequence(1, 24)
        kv.quiesce_sequence(1)
        kv.truncate_sequence(1, 8)
        with pytest.raises(AssertionError):
            kv.export_chain(1)            # chain mutated, mark gone
        kv.free_sequence(1)
        kv.assert_idle()

    def test_quiesce_refuses_a_broken_ledger_even_disarmed(self):
        for kv in (_kv(), JaxKV(JaxKVConfig(16, 128), 2, 16)):
            kv._check = False
            kv.alloc_sequence(1, 16)
            kv._ref[kv.block_table(1)[0]] += 1  # corrupt a refcount
            with pytest.raises(AssertionError, match="broken ledger"):
                kv.quiesce_sequence(1)


def _ledger_script(kv):
    """One fixed run of ledger calls with every verdict and record: the
    result of each call, or the type of what it raised, then the tables,
    lengths and refcounts."""
    out = []

    def norm(r):
        if isinstance(r, (list, tuple)):
            return [norm(x) for x in r]
        return None if r is None else int(r)

    def call(name, *args):
        try:
            out.append((name, args, "ok", norm(getattr(kv, name)(*args))))
        except Exception as e:  # the verdict is the exception's type
            out.append((name, args, type(e).__name__))

    call("alloc_sequence", 1, 40)
    call("export_chain", 1)               # refused: not quiesced
    call("quiesce_sequence", 1)
    call("export_chain", 1)
    call("extend_sequence", 1, 50)        # a write clears the mark
    call("export_chain", 1)
    call("quiesce_sequence", 1)
    call("fork_sequence", 1, 2)
    call("cow_block", 2, 3)               # cow on the fork, not on seq 1
    call("export_chain", 1)
    call("quiesce_sequence", 2)
    call("cow_block", 2, 0)               # a cow clears seq 2's mark
    call("export_chain", 2)
    call("quiesce_sequence", 2)
    call("truncate_sequence", 2, 20)      # so does a truncate
    call("export_chain", 2)
    call("unquiesce_sequence", 1)
    call("export_chain", 1)
    call("quiesce_sequence", 1)
    call("release_exported", 1)
    call("quiesce_sequence", 1)           # unknown now
    call("export_chain", 9)
    call("alloc_sequence", -5, 33)        # a staging chain
    call("adopt_sequence", 7, kv.block_table(-5) or [], 33)
    call("free_sequence", -5)
    call("quiesce_sequence", 7)
    call("free_sequence", 7)              # a free clears the mark too
    call("export_chain", 7)
    out.append(("tables", {s: kv.block_table(s)
                           for s in kv.live_sequences()}))
    out.append(("lens", {s: kv.seq_len(s) for s in kv.live_sequences()}))
    out.append(("refs", dict(sorted(kv._ref.items()))))
    out.append(("quiesced", sorted(kv._quiesced)))
    for s in kv.live_sequences():
        kv.free_sequence(s)
    kv.assert_idle()
    return out


def test_ledger_verdicts_and_records_equal_the_jax_ledger():
    jkv = JaxKV(JaxKVConfig(16, 32), 2, 16)
    jkv._check = True
    tkv = _kv(num_blocks=32)
    assert _ledger_script(tkv) == _ledger_script(jkv)


@pytest.mark.parametrize("ntokens", [1, 16, 40, 100])
def test_chain_bytes_equal_the_jax_functions(ntokens):
    """Equal pools (numpy-seeded) and equal tables: the port's payloads
    are the JAX function's bytes, and writing them leaves the JAX
    function's pools."""
    import jax.numpy as jnp

    rng = np.random.RandomState(ntokens)
    shape = (2, 129 * 16, 16)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    jkv = JaxKV(JaxKVConfig(16, 128), 2, 16)
    jkv._check = True
    tkv = _kv()
    jkv.update_pools(jnp.asarray(k), jnp.asarray(v))
    tkv.k_pool.copy_(torch.from_numpy(k))
    tkv.v_pool.copy_(torch.from_numpy(v))
    # a table out of order, as a churned pool hands out
    for kv in (jkv, tkv):
        kv.alloc_sequence(99, 16 * 20)
    table = jkv.alloc_sequence(1, ntokens)
    assert tkv.alloc_sequence(1, ntokens) == table
    bb = chain_block_bytes(tkv)
    assert bb == jax_migration.chain_block_bytes(jkv)
    got = read_chain_blocks(tkv, table, bb)
    want = jax_migration.read_chain_blocks(jkv, table, bb)
    assert got == want
    # both write the payloads into a fresh staging chain of their pool
    for kv in (jkv, tkv):
        kv.free_sequence(99)
    st = jkv.alloc_sequence(-2, ntokens)
    assert tkv.alloc_sequence(-2, ntokens) == st
    jax_migration.write_chain_blocks(jkv, st, want, ntokens)
    write_chain_blocks(tkv, st, got, ntokens)
    np.testing.assert_array_equal(tkv.k_pool.numpy(), np.asarray(jkv.k_pool))
    np.testing.assert_array_equal(tkv.v_pool.numpy(), np.asarray(jkv.v_pool))
    for kv in (jkv, tkv):
        kv.free_sequence(1)
        kv.free_sequence(-2)
        kv.assert_idle()


# --------------------------------------------------------- wire validation
class TestManifestValidation:
    def _receiver_reject(self, engine, **overrides):
        rx = MigrationReceiver(engine)
        kv = engine.kv
        fields = dict(seq_id=5, prompt_tokens=[1, 2, 3], out_tokens=[4],
                      max_new_tokens=8, stop_token=0, ntokens=4,
                      n_blocks=1, block_size=kv.block_size,
                      layers=kv.layers, kv_dim=kv.kv_dim,
                      block_bytes=chain_block_bytes(kv), recovery=False)
        fields.update(overrides)
        req = serving_pb2.MigrateRequest(**fields)
        cntl = types.SimpleNamespace(_srv_meta=None)  # no stream settings
        return rx.open(cntl, req)

    def test_open_without_stream_rejected(self):
        engine, kv, model = _build_engine()
        try:
            ack = self._receiver_reject(engine)
            assert not ack.accepted and "stream" in ack.message
        finally:
            _teardown(engine, kv, model)

    def test_geometry_and_capacity_mismatches_rejected(self):
        engine, kv, model = _build_engine()
        meta = types.SimpleNamespace(
            stream_settings=types.SimpleNamespace(stream_id=1))

        def open_with(**overrides):
            rx = MigrationReceiver(engine)
            fields = dict(seq_id=5, prompt_tokens=[1, 2, 3],
                          out_tokens=[4], max_new_tokens=8, stop_token=0,
                          ntokens=4, n_blocks=1,
                          block_size=kv.block_size, layers=kv.layers,
                          kv_dim=kv.kv_dim,
                          block_bytes=chain_block_bytes(kv),
                          recovery=False)
            fields.update(overrides)
            cntl = types.SimpleNamespace(_srv_meta=meta)
            return rx.open(cntl, serving_pb2.MigrateRequest(**fields))

        try:
            ack = open_with(block_size=8)
            assert not ack.accepted and "geometry" in ack.message
            ack = open_with(kv_dim=kv.kv_dim * 2)
            assert not ack.accepted and "geometry" in ack.message
            ack = open_with(block_bytes=1)
            assert not ack.accepted and "block_bytes" in ack.message
            # 1 block cannot carry 40 tokens at block_size 16
            ack = open_with(ntokens=40)
            assert not ack.accepted and "cannot carry" in ack.message
            kv.assert_idle("rejects must not leak staging chains")
        finally:
            _teardown(engine, kv, model)

    def test_commit_unknown_sequence_rejected(self):
        engine, kv, model = _build_engine()
        try:
            rx = MigrationReceiver(engine)
            ack = rx.commit(None,
                            serving_pb2.MigrateCommitRequest(seq_id=99))
            assert not ack.accepted and "no open migration" in ack.message
        finally:
            _teardown(engine, kv, model)


# ---------------------------------------------------- disaggregated plane
@pytest.fixture
def disagg_pair():
    """A prefill-role engine and a decode-role engine behind the port's
    loopback Server with LlmServingService, wired with a KVMigrator: the
    smallest disaggregated deployment."""
    dec, dec_kv, dec_model = _build_engine(role="decode")
    srv = Server().add_service(
        LlmServingService(dec)).start("127.0.0.1:0")
    pre, pre_kv, pre_model = _build_engine(role="prefill")
    pre.set_migrator(KVMigrator(f"{srv.listen_endpoint()}"))
    yield pre, dec, srv
    pre.stop()
    srv.stop()
    srv.join(timeout=2)
    dec.stop()
    # the gate: no leaked block on EITHER armed pool
    pre_kv.assert_idle("prefill pool after disaggregated run")
    dec_kv.assert_idle("decode pool after disaggregated run")
    pre_model.close()
    dec_model.close()


class TestDisaggregatedServing:
    def test_corpus_schedule_bit_identical_to_colocated(self, disagg_pair):
        """Every sequence of the corpus schedule, prefilled on one engine,
        migrated and decoded on the other, gives the co-located engine's
        greedy tokens exactly (the port's and the JAX package's), and the
        decode engine never prefills a token."""
        pre, dec, _srv = disagg_pair
        ref = _colocated(SCHEDULE)
        assert ref == _jax_colocated(SCHEDULE)
        assert dec.prefill_tokens == 0
        got = []
        for plen, max_new in SCHEDULE:
            code, _seq, ev, box = _submit(
                pre, pre.model.synth_prompt(plen), max_new)
            assert code == 0
            assert ev.wait(300), "prefill stage stalled"
            h = box["r"]
            assert h.finish_reason == "handoff"
            assert h.handoff_shard == pre.migrator.dest_shard
            assert len(h.tokens) >= 1  # prefill emitted the first token
            got.append(list(h.tokens) + list(_resume(dec, h).tokens))
        assert got == ref
        assert dec.prefill_tokens == 0
        assert pre.prefill_tokens == sum(p for p, _ in SCHEDULE)
        assert pre.migrator.seqs == len(SCHEDULE)
        assert pre.migrator.failed == 0
        assert pre.migrator.blocks == sum(
            pre.kv.blocks_for(p) for p, _ in SCHEDULE)
        assert pre.migrator.bytes == \
            pre.migrator.blocks * chain_block_bytes(pre.kv)

    def test_resume_attach_is_single_use(self, disagg_pair):
        pre, dec, _srv = disagg_pair
        code, _s, ev, box = _submit(pre, pre.model.synth_prompt(16), 4)
        assert code == 0 and ev.wait(300)
        h = box["r"]
        _resume(dec, h)
        # the sequence finished and detached: a second attach is EREQUEST
        code, _s3, _ev3, _b3 = _submit(
            dec, np.zeros(0, dtype=np.int32), 0, resume=h.seq_id)
        assert code == errors.EREQUEST

    def test_unknown_resume_id_is_erequest(self, disagg_pair):
        _pre, dec, _srv = disagg_pair
        code, _s, _ev, _b = _submit(
            dec, np.zeros(0, dtype=np.int32), 0, resume=424242)
        assert code == errors.EREQUEST

    def test_migrate_metrics_and_snapshot(self, disagg_pair):
        pre, dec, _srv = disagg_pair
        seqs0 = g_serving_migrate_seqs.get_value()
        code, _s, ev, box = _submit(pre, pre.model.synth_prompt(16), 4)
        assert code == 0 and ev.wait(300)
        _resume(dec, box["r"])
        assert g_serving_migrate_seqs.get_value() == seqs0 + 1
        out = pre.snapshot()["migration"]
        assert pre.snapshot()["role"] == "prefill"
        assert out["parked"] == 0
        assert out["out"]["seqs"] >= 1 and out["out"]["bytes"] > 0
        assert out["out"]["gbps"] > 0
        inn = dec.snapshot()["migration"]
        assert dec.snapshot()["role"] == "decode"
        assert inn["in"]["seqs_in"] >= 1
        assert inn["in"]["pending_in"] == 0


def test_resume_over_the_decode_engines_server(disagg_pair):
    """Stage 2 as a client sends it: ``Generate(resume_seq_id=)`` to the
    decode engine's Server answers the tokens decoded there, which after
    the handoff's give the co-located tokens; a second resume of the
    same sequence fails with EREQUEST over the wire too."""
    from brpc_tpu_torch import rpc

    pre, dec, srv = disagg_pair
    ref = _colocated([(24, 6)])[0]
    code, _s, ev, box = _submit(pre, pre.model.synth_prompt(24), 6)
    assert code == 0 and ev.wait(300)
    h = box["r"]
    assert h.finish_reason == "handoff"
    stub = rpc.Stub(rpc.Channel(rpc.ChannelOptions(timeout_ms=60000)).init(
        str(srv.listen_endpoint())),
        serving_pb2.DESCRIPTOR.services_by_name["LlmService"])
    resp = stub.Generate(serving_pb2.GenerateRequest(resume_seq_id=h.seq_id))
    assert list(h.tokens) + list(resp.tokens) == ref
    assert resp.seq_id == h.seq_id and resp.steps == len(resp.tokens)
    with pytest.raises(rpc.RpcError) as ei:
        stub.Generate(serving_pb2.GenerateRequest(resume_seq_id=h.seq_id))
    assert ei.value.error_code == errors.EREQUEST


# ------------------------------------------------------------------ chaos
@pytest.mark.chaos
class TestMigrationChaos:
    def test_drop_fault_falls_back_to_local_decode(self, fault_enabled,
                                                   disagg_pair):
        """serving.migrate.drop kills the destination tunnel on every
        transfer: the source keeps the chain and decodes the sequence
        LOCALLY to the same greedy tokens, with no leaked block on either
        armed pool (the fixture's teardown proves it)."""
        pre, dec, _srv = disagg_pair
        ref_toks = _colocated([(16, 6)])[0]
        failed0 = g_serving_migrate_failed.get_value()
        fault.arm("serving.migrate.drop", mode="always")
        try:
            code, _s, ev, box = _submit(pre, pre.model.synth_prompt(16), 6)
            assert code == 0
            assert ev.wait(300), "local-fallback decode stalled"
        finally:
            fault.disarm_all()
        r = box["r"]
        # NOT a handoff: the prefill engine finished the whole generation
        assert r.finish_reason == "length"
        assert list(r.tokens) == ref_toks
        assert pre.migrator.failed >= 1
        assert g_serving_migrate_failed.get_value() > failed0
        # the decode engine adopted nothing
        assert dec.snapshot()["migration"]["in"]["seqs_in"] == 0
        assert dec.snapshot()["migration"]["in"]["pending_in"] == 0

    def test_stall_fault_delays_but_completes(self, fault_enabled,
                                              disagg_pair):
        pre, dec, _srv = disagg_pair
        fault.arm("serving.migrate.stall", mode="oneshot", delay_ms=50)
        try:
            t0 = time.monotonic()
            code, _s, ev, box = _submit(pre, pre.model.synth_prompt(16), 4)
            assert code == 0 and ev.wait(300)
            h = box["r"]
            assert h.finish_reason == "handoff"
            assert time.monotonic() - t0 >= 0.05
        finally:
            fault.disarm_all()
        _resume(dec, h)

    def test_shard_death_drains_onto_survivor_without_reprefill(self):
        """Kill an engine mid-generation: stop() drains its live chain to
        the survivor, the client's retry of the SAME request attaches to
        the migrated sequence by prompt match, and the whole generation
        equals an uninterrupted run, with the survivor prefilling no
        token."""
        ref_toks = _colocated([(24, 32)])[0]
        dying, dying_kv, dying_model = _build_engine()
        surv, surv_kv, surv_model = _build_engine()
        srv = Server().add_service(
            LlmServingService(surv)).start("127.0.0.1:0")
        dying.set_migrator(KVMigrator(f"{srv.listen_endpoint()}"))
        try:
            cntl = types.SimpleNamespace(failed_code=0)
            box = {}
            ev = threading.Event()

            def set_failed(code, msg):
                cntl.failed_code = code
                cntl.failed_msg = msg

            cntl.set_failed = set_failed
            code, seq = dying.submit(
                dying_model.synth_prompt(24), 32, cntl=cntl,
                done=lambda r, box=box, ev=ev: (box.update(r=r),
                                                ev.set()))
            assert code == 0
            # let it decode a few tokens, then kill the engine
            deadline = time.monotonic() + 60
            while len(seq.out_tokens) < 4:
                assert time.monotonic() < deadline, "decode never started"
                time.sleep(0.005)
            dying.stop()
            assert ev.wait(60), "doomed RPC never completed"
            # the client saw a RETRIABLE failure naming the drain
            assert box["r"] is None
            assert cntl.failed_code == errors.EFAILEDSOCKET
            assert "migrated to survivor" in cntl.failed_msg
            assert dying.migrator.seqs == 1
            # the retry: the same prompt and max_new on the survivor
            # attaches to the live migrated sequence, no prefill
            pf0 = surv.prefill_tokens
            code, _s2, ev2, box2 = _submit(
                surv, surv_model.synth_prompt(24), 32)
            assert code == 0
            assert ev2.wait(300), "recovered generation stalled"
            r = box2["r"]
            assert list(r.tokens) == ref_toks
            assert surv.prefill_tokens == pf0  # no re-prefilled token
        finally:
            srv.stop()
            srv.join(timeout=2)
            surv.stop()
            dying_kv.assert_idle("dying pool after drain")
            surv_kv.assert_idle("survivor pool after recovery")
            dying_model.close()
            surv_model.close()


def test_disaggregated_port_equals_the_jax_colocated_engine_concurrently(
        disagg_pair):
    """The corpus schedule submitted all at once to the prefill engine
    (handoffs and resumes interleaved with decode on the other engine)
    gives the JAX co-located engine's tokens."""
    pre, dec, _srv = disagg_pair
    want = _jax_colocated(SCHEDULE)
    boxes = []
    for plen, max_new in SCHEDULE:
        code, _s, ev, box = _submit(pre, pre.model.synth_prompt(plen),
                                    max_new)
        assert code == 0
        boxes.append((ev, box))
    got = []
    for ev, box in boxes:
        assert ev.wait(300)
        h = box["r"]
        assert h.finish_reason == "handoff"
        got.append(list(h.tokens) + list(_resume(dec, h).tokens))
    assert got == want
    assert dec.prefill_tokens == 0


# ------------------------------------------------------------ observability
class TestMigrationObservability:
    def test_backlog_watch_rule_installed_and_reloadable(self):
        from brpc_tpu_torch.metrics.watch import (global_watch,
                                                  install_default_rules)

        install_default_rules()
        rules = {r.name: r for r in global_watch().rules()}
        assert "serving_migrate_backlog" in rules
        rule = rules["serving_migrate_backlog"]
        assert rule.var == "g_serving_migrate_inflight"
        assert rule.kind == "threshold"
        assert rule.bound() == float(
            _flags.get("serving_migrate_backlog_max"))
        old = _flags.get("serving_migrate_backlog_max")
        try:
            _flags.set_flag("serving_migrate_backlog_max", "2")
            assert rule.bound() == 2.0  # reloadable, no restart
        finally:
            _flags.set_flag("serving_migrate_backlog_max", str(old))

    def test_serving_builtin_reports_migration(self, disagg_pair):
        """The reference's ``/serving`` case on the port's page: a
        migrated sequence shows on both roles' migrate lines and in the
        JSON view, whose sections are each engine's snapshot."""
        import json as _json

        from brpc_tpu_torch.builtin.services import serving_service

        pre, dec, _srv = disagg_pair
        code, _s, ev, box = _submit(pre, pre.model.synth_prompt(16), 4)
        assert code == 0 and ev.wait(300)
        h = box["r"]
        code, _s2, ev2, _b2 = _submit(
            dec, np.zeros(0, dtype=np.int32), 0, resume=h.seq_id)
        assert code == 0 and ev2.wait(300)

        http = types.SimpleNamespace(query={}, path="/serving")
        _st, _ct, body = serving_service(None, http)
        mig_lines = [l for l in body.splitlines()
                     if l.strip().startswith("migrate:")]
        assert mig_lines, body
        joined = "\n".join(mig_lines)
        assert "role=prefill" in joined and "role=decode" in joined
        assert "out ->" in joined and "in seqs" in joined

        http = types.SimpleNamespace(query={"format": "json"},
                                     path="/serving")
        _st, ct, body = serving_service(None, http)
        assert "json" in ct
        snaps = _json.loads(body)["engines"]
        migs = [s["migration"] for s in snaps if s.get("migration")]
        assert any(m.get("out", {}).get("seqs", 0) >= 1 for m in migs)
        assert any(m.get("in", {}).get("seqs_in", 0) >= 1 for m in migs)
        for eng in (pre, dec):
            want = _json.loads(_json.dumps(eng.snapshot()["migration"]))
            assert want in migs

    def test_migration_vars_exposed(self):
        from brpc_tpu_torch.metrics.variable import get_exposed
        from brpc_tpu_torch.serving import migration as _mig

        # another test may have cleared the registry; re-expose the
        # import-time variables so the /vars contract stays checkable
        for name in ("g_serving_migrate_seqs", "g_serving_migrate_blocks",
                     "g_serving_migrate_bytes", "g_serving_migrate_failed",
                     "g_serving_migrate_inflight"):
            if get_exposed(name) is None:
                var = getattr(_mig, name)
                (var.expose_as if hasattr(var, "expose_as")
                 else var.expose)(name)
            assert get_exposed(name) is not None, name

    def test_migration_flags_equal_the_reference(self):
        from brpc_tpu import flags as jax_flags

        for name in ("serving_migrate_window_mb",
                     "serving_migrate_timeout_ms",
                     "serving_migrate_backlog_max"):
            assert _flags.get(name) == jax_flags.get(name), name
