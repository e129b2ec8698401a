"""KV migration to and from a rank-mesh engine (brpc_tpu_torch.serving's
ShardedKVCache.read_chain / write_chain under serving/migration.py)
against the JAX package on the CPU.

The port side runs as 8 gloo ranks on the CPU (dp2 x sp2 x tp2, this
process rank 0), launched ONCE for the module by the ``migrated``
fixture, which drives every case and keeps its results; each test holds
its own case. A rank-mesh engine is a MeshTransformer over a
ShardedKVCache on the launched mesh (each dp shard's pools on its own
rank); its partner is the port's replayed mesh engine on ``use_cpu(8)``'s
positions, or a single-device engine. The JAX side is the reference's
mesh engine on the conftest's 8 virtual CPU devices, co-located.

What is held:

- ``tests/test_torch_mesh_serving.py``'s migration case with the prefill
  engine, the decode engine, and both on the rank mesh: the corpus
  schedule disaggregated gives the JAX co-located engine's greedy tokens,
  the decode engine prefills nothing, migrated blocks and bytes are
  exact, and both armed pools end idle;
- a rank-mesh engine stopped mid-generation drains its live chain onto a
  single-device survivor, whose retry attaches with no prefill and ends
  with the JAX co-located engine's tokens; both pools end idle;
- a chain's slot gather on its shard's rank gives the bytes written into
  those slots, the same bytes ``shard_pools``' full read holds there, and
  the write leaves the other shard's pools as they were.

Tolerance: none. Tokens and block bytes must be equal (fp32 on both
sides, plain attention; migrated bytes are copied, never recomputed).
"""

import threading
import time
import types

import numpy as np
import pytest
import torch

from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import MeshTransformer as JaxMeshModel
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import ShardedKVCache as JaxShardedKV
from brpc_tpu_torch.rpc import Server, errors
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    MeshTransformer, ModelConfig,
                                    PagedKVCache, ServingEngine,
                                    ShardedKVCache, TinyTransformer)
from brpc_tpu_torch.serving.kv_cache import chain_slots
from brpc_tpu_torch.serving.migration import (KVMigrator, chain_block_bytes,
                                              read_chain_blocks,
                                              write_chain_blocks)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.serving.weights import params_from_jax
from brpc_tpu_torch.tpu import launch
from brpc_tpu_torch.tpu import mesh as port_mesh
from tests.test_torch_tracemalloc_guard import (  # noqa: F401
    no_leaked_tracemalloc, no_leaked_tracemalloc_in_module)
from tools.record_serving_corpus import SCHEDULE

CFG = dict(vocab=256, d_model=32, n_heads=2, n_layers=2)
AXES = {"dp": 2, "sp": 2, "tp": 2}
BLOCK = 16
NUM_BLOCKS = 128
# which engine of the disaggregated pair runs on the rank mesh
ON_RANKS = ("prefill", "decode", "both")
DRAIN = (24, 48)     # the drained request: prompt length, max new tokens
SLOT_TOKENS = 40     # the gathered chain: 3 blocks


def _jax_params(jm):
    return {name: np.asarray(a) for name, a in jm._params.items()}


@pytest.fixture(scope="module")
def jax_stack():
    jcfg = JaxModelConfig(**CFG)
    jkv = JaxShardedKV(JaxKVConfig(BLOCK, 256), jcfg.n_layers, jcfg.kv_dim)
    jkv._check = True
    jm = JaxMeshModel(jcfg, jkv)
    yield jm
    jm.close()
    jkv.close()


@pytest.fixture(scope="module")
def jax_colocated(jax_stack):
    """The JAX mesh engine's greedy tokens, co-located: the corpus
    schedule and the drained request, each on its own."""
    engine = JaxEngine(jax_stack, jax_stack.kv, JaxEngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002),
        prefix_cache=False).start()
    try:
        out = []
        for plen, max_new in list(SCHEDULE) + [DRAIN]:
            ev = threading.Event()
            code, seq = engine.submit(jax_stack.synth_prompt(plen), max_new,
                                      done=lambda _r, ev=ev: ev.set())
            assert code == 0 and ev.wait(300), "JAX reference stalled"
            out.append([int(t) for t in seq.out_tokens])
    finally:
        engine.stop()
    jax_stack.kv.assert_idle()
    return {"corpus": out[:-1], "drain": out[-1]}


def _model(params, mesh=None, single=False):
    """An armed port model holding the JAX weights: a MeshTransformer
    over ``mesh`` (a rank mesh) or over the replayed serving mesh, or a
    single-device TinyTransformer."""
    c = ModelConfig(**CFG)
    if single:
        kv = PagedKVCache(KVCacheConfig(BLOCK, NUM_BLOCKS), c.n_layers,
                          c.kv_dim, device="cpu")
        model = TinyTransformer(c, kv)
    else:
        kv = ShardedKVCache(KVCacheConfig(BLOCK, NUM_BLOCKS), c.n_layers,
                            c.kv_dim, mesh=mesh)
        model = MeshTransformer(c, kv)
    kv._check = True
    model.load_params(params_from_jax(params, "cpu"))
    return model


def _idle(kv, what):
    try:
        kv.assert_idle(what)
        return None
    except AssertionError as e:
        return str(e)


def _close(model):
    model.close()
    model.kv.close()


def _engine(model, role="both"):
    return ServingEngine(model, model.kv, EngineConfig(
        max_batch=8, token_budget=512, idle_wait_s=0.002, role=role),
        prefix_cache=False).start()


def _disaggregated(pre, dec):
    """The corpus schedule through a prefill-role engine on ``pre`` that
    hands each chain to a decode-role engine on ``dec`` behind the port's
    Server; one request at a time, each resumed on the decode engine.
    The engines stop before their models close, while the ranks are up."""
    d_eng = _engine(dec, "decode")
    srv = Server().add_service(LlmServingService(d_eng)).start(
        "127.0.0.1:0")
    p_eng = _engine(pre, "prefill")
    p_eng.set_migrator(KVMigrator(str(srv.listen_endpoint())))
    out = {"tokens": [], "reasons": []}
    try:
        for plen, max_new in SCHEDULE:
            box, ev = {}, threading.Event()
            code, _ = p_eng.submit(
                pre.synth_prompt(plen), max_new,
                done=lambda r, box=box, ev=ev: (box.update(r=r), ev.set()))
            assert code == 0 and ev.wait(300), "prefill stage stalled"
            h = box["r"]
            out["reasons"].append(h.finish_reason)
            box2, ev2 = {}, threading.Event()
            code, _ = d_eng.submit(
                np.zeros(0, dtype=np.int32), 0, resume_seq_id=h.seq_id,
                done=lambda r, box=box2, ev=ev2: (box.update(r=r),
                                                   ev.set()))
            assert code == 0 and ev2.wait(300), "decode stage stalled"
            out["tokens"].append(list(h.tokens) + list(box2["r"].tokens))
        m = p_eng.migrator
        out.update(decode_prefill_tokens=d_eng.prefill_tokens,
                   prefill_tokens=p_eng.prefill_tokens, failed=m.failed,
                   seqs=m.seqs, blocks=m.blocks, bytes=m.bytes,
                   seqs_in=d_eng.snapshot()["migration"]["in"]["seqs_in"],
                   block_bytes=chain_block_bytes(pre.kv),
                   want_blocks=sum(pre.kv.blocks_for(p)
                                   for p, _ in SCHEDULE))
    finally:
        p_eng.stop()
        srv.stop()
        srv.join(timeout=2)
        d_eng.stop()
    out["idle"] = [_idle(pre.kv, "prefill pool after the migration"),
                   _idle(dec.kv, "decode pool after the migration")]
    return out


def _drain(params, mesh):
    """A rank-mesh engine with a migrator to a single-device survivor is
    stopped mid-generation: its live chain moves to the survivor, and the
    client's retry of the same request attaches there."""
    dying_model = _model(params, mesh)
    surv_model = _model(params, single=True)
    dying = _engine(dying_model)
    surv = _engine(surv_model)
    srv = Server().add_service(LlmServingService(surv)).start(
        "127.0.0.1:0")
    dying.set_migrator(KVMigrator(str(srv.listen_endpoint())))
    out = {}
    try:
        cntl = types.SimpleNamespace(failed_code=0, failed_msg="")

        def set_failed(code, msg):
            cntl.failed_code, cntl.failed_msg = code, msg

        cntl.set_failed = set_failed
        box, ev = {}, threading.Event()
        plen, max_new = DRAIN
        code, seq = dying.submit(
            dying_model.synth_prompt(plen), max_new, cntl=cntl,
            done=lambda r, box=box, ev=ev: (box.update(r=r), ev.set()))
        assert code == 0
        deadline = time.monotonic() + 60
        while len(seq.out_tokens) < 4:
            assert time.monotonic() < deadline, "decode never started"
            time.sleep(0.002)
        # the drain runs inside stop(), on the ranks: stop before the
        # group (or the model) closes
        dying.stop()
        assert ev.wait(60), "the drained request never completed"
        out.update(result=box["r"], failed_code=cntl.failed_code,
                   failed_msg=cntl.failed_msg,
                   drained_at=len(seq.out_tokens),
                   migrated=dying.migrator.seqs)
        pf0 = surv.prefill_tokens
        box2, ev2 = {}, threading.Event()
        code, _ = surv.submit(
            surv_model.synth_prompt(plen), max_new,
            done=lambda r, box=box2, ev=ev2: (box.update(r=r), ev.set()))
        assert code == 0 and ev2.wait(300), "recovered generation stalled"
        out.update(tokens=list(box2["r"].tokens),
                   survivor_prefill=surv.prefill_tokens - pf0)
    finally:
        srv.stop()
        srv.join(timeout=2)
        surv.stop()
    out["idle"] = [_idle(dying_model.kv, "dying pool after the drain"),
                   _idle(surv_model.kv, "survivor pool after recovery")]
    _close(dying_model)
    _close(surv_model)
    return out


def _slot_gather(mesh):
    """On a ranked cache: seeded payloads written into a staged chain of
    each shard (``write_chain_blocks``), then read back by the chain's
    slot gather (``read_chain_blocks``) and by ``shard_pools``' full
    read."""
    c = ModelConfig(**CFG)
    kv = ShardedKVCache(KVCacheConfig(BLOCK, 32), c.n_layers, c.kv_dim,
                        mesh=mesh)
    kv._check = True
    rng = np.random.default_rng(7)
    out = {}
    try:
        for shard in range(kv.n_shards):
            sid = next(s for s in range(1, 100) if kv.shard_of(s) == shard)
            table = kv.alloc_sequence(sid, SLOT_TOKENS)
            bb = chain_block_bytes(kv)
            sent = [rng.normal(size=bb // 4).astype(np.float32).tobytes()
                    for _ in table]
            before = [p.numpy() for p in kv.shard_pools(1 - shard)]
            write_chain_blocks(kv, table, sent, SLOT_TOKENS)
            got = read_chain_blocks(kv, table, bb)
            pools = [[p.numpy() for p in kv.shard_pools(i)]
                     for i in range(kv.n_shards)]
            out[shard] = {"table": list(table), "sent": sent, "got": got,
                          "gather": kv.read_chain(table).numpy(),
                          "pools": pools, "other_before": before}
            kv.free_sequence(sid)
        out["idle"] = _idle(kv, "after the slot gathers")
    finally:
        kv.close()
    return out


@pytest.fixture(scope="module")
def migrated(jax_stack):
    """Every case's port side over one launch of 8 CPU ranks."""
    params = _jax_params(jax_stack)
    out = {"disagg": {}}
    port_mesh.use_cpu(8)   # the replayed mesh engine's positions
    group = launch.launch(AXES, device="cpu")
    try:
        out["slots"] = _slot_gather(group.mesh)
        for case in ON_RANKS:
            pre = _model(params, group.mesh if case != "decode" else None)
            dec = _model(params, group.mesh if case != "prefill" else None)
            try:
                out["disagg"][case] = _disaggregated(pre, dec)
            finally:
                _close(pre)
                _close(dec)
        out["drain"] = _drain(params, group.mesh)
    finally:
        group.close()
        port_mesh.use_cpu(0)
    return out


@pytest.mark.parametrize("case", ON_RANKS)
def test_chain_migrated_between_mesh_engines_decodes_the_colocated_tokens(
        migrated, jax_colocated, case):
    r = migrated["disagg"][case]
    assert r["reasons"] == ["handoff"] * len(SCHEDULE)
    assert r["tokens"] == jax_colocated["corpus"]
    assert r["decode_prefill_tokens"] == 0
    assert r["prefill_tokens"] == sum(p for p, _ in SCHEDULE)
    assert r["failed"] == 0
    assert r["seqs"] == r["seqs_in"] == len(SCHEDULE)
    assert r["blocks"] == r["want_blocks"]
    assert r["bytes"] == r["blocks"] * r["block_bytes"] == \
        r["blocks"] * 2 * CFG["n_layers"] * BLOCK * CFG["d_model"] * 4
    assert r["idle"] == [None, None]


def test_a_stopping_rank_mesh_engine_drains_onto_the_survivor(
        migrated, jax_colocated):
    r = migrated["drain"]
    assert r["result"] is None
    assert r["failed_code"] == errors.EFAILEDSOCKET
    assert "migrated to survivor" in r["failed_msg"]
    assert r["migrated"] == 1 and r["drained_at"] < DRAIN[1]
    assert r["tokens"] == jax_colocated["drain"]
    assert r["survivor_prefill"] == 0
    assert r["idle"] == [None, None]


@pytest.mark.parametrize("shard", [0, 1])
def test_chain_slot_gather_equals_the_full_shard_read(migrated, shard):
    r = migrated["slots"][shard]
    assert r["got"] == r["sent"]
    slots = chain_slots(r["table"], BLOCK).numpy()
    k, v = r["pools"][shard]
    n = len(r["table"])
    full = np.stack([k[:, slots], v[:, slots]]).reshape(
        2, CFG["n_layers"], n, BLOCK, CFG["d_model"]).transpose(2, 0, 1, 3, 4)
    np.testing.assert_array_equal(r["gather"], full)
    assert b"".join(r["got"]) == full.tobytes()
    for after, before in zip(r["pools"][1 - shard], r["other_before"]):
        np.testing.assert_array_equal(after, before)
    assert migrated["slots"]["idle"] is None


def test_chain_slots_are_the_table_blocks_slots_in_order():
    got = chain_slots([3, 1], 4)
    assert got.dtype == torch.int64
    assert got.tolist() == [12, 13, 14, 15, 4, 5, 6, 7]
