"""The port's sharded Generate router (brpc_tpu_torch/serving/router.py)
held against the JAX package's (brpc_tpu/serving/router.py) on the CPU.

- The four ``TestGenerateRouter`` cases and the three
  ``TestShardedGenerateChaos`` cases of ``tests/test_serving_mesh.py``,
  the prefix-hash routing cases of ``tests/test_serving_prefix.py`` and
  the two-stage router of ``tests/test_serving_migration.py``, on port
  engines (``device="cpu"``) behind the port's Servers.
- On seeded requests (token prompts, synth lengths, block sizes, two and
  four partitions, a prefill-partition split) the port's route keys and
  owners equal the JAX router's.
- A two-shard port fleet behind the port's ``ShardedLlmChannel`` and a
  two-shard JAX fleet behind the JAX one, given the same requests: each
  lands on the same shard and the greedy tokens are equal (no tolerance:
  both fp32 with plain attention, weights from the same seed).

The chaos cases kill the owner once its engine is decoding the doomed
sequence (read from the engine, not a clock), with the decode step
stalled by the ``serving.decode.stall`` fault so the sequence cannot
finish first.
"""

import threading
import time

import numpy as np
import pytest

import brpc_tpu.proto.serving_pb2 as jax_pb
import brpc_tpu.rpc as jax_rpc
from brpc_tpu.serving import EngineConfig as JaxEngineConfig
from brpc_tpu.serving import KVCacheConfig as JaxKVConfig
from brpc_tpu.serving import LlmServingService as JaxService
from brpc_tpu.serving import ModelConfig as JaxModelConfig
from brpc_tpu.serving import PagedKVCache as JaxKV
from brpc_tpu.serving import ServingEngine as JaxEngine
from brpc_tpu.serving import TinyTransformer as JaxModel
from brpc_tpu.serving import router as jax_router
from brpc_tpu_torch import fault
from brpc_tpu_torch import flags as _flags
from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import (ChannelOptions, Controller, RpcError, Server,
                                errors)
from brpc_tpu_torch.rpc.combo_channels import SKIP
from brpc_tpu_torch.serving import (EngineConfig, KVCacheConfig,
                                    ModelConfig, PagedKVCache,
                                    ServingEngine, ShardedKVCache,
                                    ShardedLlmChannel, ShardedPrefixCache,
                                    TinyTransformer, prefix_route_key)
from brpc_tpu_torch.serving.migration import KVMigrator
from brpc_tpu_torch.serving.router import (GENERATE_MD, STATS_MD,
                                           GenerateRouter, StatsMerger,
                                           generate_route_key)
from brpc_tpu_torch.serving.service import LlmServingService
from brpc_tpu_torch.shard.plane import shard_for
from brpc_tpu_torch.tpu import mesh
from tools.record_serving_corpus import SCHEDULE

CFG = dict(vocab=256, d_model=32, n_heads=2)


# ----------------------------------------------------------- the router
class TestGenerateRouter:
    def test_generate_maps_to_single_owner_partition(self):
        req = serving_pb2.GenerateRequest(prompt_tokens=[3, 1, 4, 1, 5])
        for n in (2, 4):
            router = GenerateRouter(n)
            decisions = [router.map(i, GENERATE_MD, req, None)
                         for i in range(n)]
            live = [i for i, d in enumerate(decisions) if d is not SKIP]
            assert live == [shard_for(generate_route_key(req), n)]

    def test_stats_fans_out_to_every_partition(self):
        router = GenerateRouter(4)
        req = serving_pb2.ServingStatsRequest()
        decisions = [router.map(i, STATS_MD, req, None) for i in range(4)]
        assert all(d is not SKIP for d in decisions)

    def test_route_key_deterministic_and_prompt_dependent(self):
        a = serving_pb2.GenerateRequest(prompt_tokens=[1, 2, 3])
        b = serving_pb2.GenerateRequest(prompt_tokens=[1, 2, 4])
        assert generate_route_key(a) == generate_route_key(a)
        assert generate_route_key(a) != generate_route_key(b)
        # synth-prompt requests route on prompt_len
        c = serving_pb2.GenerateRequest(prompt_len=16)
        d = serving_pb2.GenerateRequest(prompt_len=32)
        assert generate_route_key(c) != generate_route_key(d)

    def test_stats_merger_sums_shard_gauges(self):
        merger = StatsMerger()
        total = serving_pb2.ServingStats()
        for used in (3, 5):
            sub = serving_pb2.ServingStats(
                seqs_running=1, seqs_waiting=2, kv_blocks_total=128,
                kv_blocks_used=used, steps=10, tokens_generated=40)
            assert merger.merge(total, sub) == merger.MERGED
        assert total.kv_blocks_total == 256
        assert total.kv_blocks_used == 8
        assert total.seqs_running == 2 and total.tokens_generated == 80


def _requests(seed, n=24):
    """Seeded GenerateRequest field sets: token prompts of 1-60 tokens
    (some sharing a first block), synth lengths, and resumes."""
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(0, 256, 16)]
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append(dict(prompt_len=int(rng.integers(1, 200))))
        elif kind == 1:
            out.append(dict(prompt_tokens=[
                int(t) for t in rng.integers(0, 1 << 20,
                                             int(rng.integers(1, 60)))]))
        elif kind == 2:
            out.append(dict(prompt_tokens=shared + [
                int(t) for t in rng.integers(0, 256,
                                             int(rng.integers(1, 30)))]))
        else:
            out.append(dict(resume_seq_id=int(rng.integers(1, 1000)),
                            resume_shard=int(rng.integers(0, 2))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("n,block_size,prefill", [
    (2, 0, None), (4, 0, None), (2, 16, None), (4, 16, None),
    (3, 8, None), (4, 0, [0, 2]), (2, 16, [0])])
def test_route_keys_and_owners_equal_the_jax_router(seed, n, block_size,
                                                    prefill):
    port = GenerateRouter(n, block_size=block_size,
                          prefill_partitions=prefill)
    ref = jax_router.GenerateRouter(n, block_size=block_size,
                                    prefill_partitions=prefill)
    for fields in _requests(seed):
        p_req = serving_pb2.GenerateRequest(**fields)
        j_req = jax_pb.GenerateRequest(**fields)
        if not fields.get("resume_seq_id"):
            assert port.route_key(p_req) == ref.route_key(j_req), fields
            assert generate_route_key(p_req) \
                == jax_router.generate_route_key(j_req)
        assert port.owner_of(p_req) == ref.owner_of(j_req), fields
        for i in range(n):
            p_live = port.map(i, GENERATE_MD, p_req, None) is not SKIP
            j_live = ref.map(i, jax_router.GENERATE_MD, j_req,
                             None) is not jax_router.SKIP
            assert p_live == j_live


# ------------------------------------------------- prefix-hash routing
class TestPrefixRouting:
    def test_route_key_none_below_one_block_plus_suffix(self):
        assert prefix_route_key(list(range(16)), 16) is None
        assert prefix_route_key(list(range(17)), 16) is not None

    def test_route_key_depends_only_on_the_first_block(self):
        a = list(range(1, 40))
        b = a[:16] + [9] * 30
        assert prefix_route_key(a, 16) == prefix_route_key(b, 16)
        c = [2] + a[1:]
        assert prefix_route_key(c, 16) != prefix_route_key(a, 16)

    def test_client_and_server_place_the_same_shard(self):
        """The fleet contract: the client's GenerateRouter and the
        server's ShardedPrefixCache compute the SAME shard for a prompt,
        so same-prefix traffic lands where the chain lives."""
        mesh.use_cpu(8)  # the serving mesh's 8 positions on the CPU
        kv = ShardedKVCache(KVCacheConfig(block_size=16, num_blocks=64),
                            1, 8)
        try:
            spc = ShardedPrefixCache(kv)
            router = GenerateRouter(kv.n_shards, block_size=16)
            placed = set()
            for seed in range(12):
                toks = [seed * 31 + i for i in range(20)]
                req = serving_pb2.GenerateRequest(prompt_tokens=toks)
                client = shard_for(router.route_key(req), kv.n_shards)
                assert client == spc.route_shard(toks)
                placed.add(client)
            assert placed == {0, 1}  # the hash actually spreads
            short = serving_pb2.GenerateRequest(prompt_tokens=[1, 2, 3])
            assert router.route_key(short) == generate_route_key(short)
            assert spc.route_shard([1, 2, 3]) is None
        finally:
            kv.close()
            mesh.use_cpu(0)


# ------------------------------------------------------ fleets on the CPU
def _port_shard(n_layers=2, num_blocks=64, max_batch=4, token_budget=256,
                role="both", prefix_cache=None):
    cfg = ModelConfig(n_layers=n_layers, **CFG)
    kv = PagedKVCache(KVCacheConfig(block_size=16, num_blocks=num_blocks),
                      cfg.n_layers, cfg.kv_dim, device="cpu")
    kv._check = True
    model = TinyTransformer(cfg, kv)
    engine = ServingEngine(model, kv, EngineConfig(
        max_batch=max_batch, token_budget=token_budget, idle_wait_s=0.002,
        role=role), prefix_cache=prefix_cache).start()
    srv = Server().add_service(LlmServingService(engine)).start(
        "127.0.0.1:0")
    return srv, engine, model, kv


def _url(fleet):
    return (f"list://{fleet[0][0].listen_endpoint()} 0/2,"
            f"{fleet[1][0].listen_endpoint()} 1/2")


def _close_port_fleet(fleet):
    for srv, engine, model, kv in fleet:
        srv.stop()
        srv.join(timeout=2)
        engine.stop()
        kv.assert_idle()  # zero leaked blocks, zero cache holds
        model.close()


@pytest.fixture
def stalled_decode():
    """Each decode step sleeps 5 ms: a 200-token generation outlives the
    kill by far."""
    _flags.set_flag("fault_injection_enabled", True)
    fault.arm("serving.decode.stall", mode="always", delay_ms=5)
    yield
    fault.disarm_all()
    _flags.set_flag("fault_injection_enabled", False)


def _kill_when_decoding(srv, engine, tokens_before):
    """Stop the server, force-closing its connections, once the engine
    has decoded past ``tokens_before``."""
    def run():
        deadline = time.monotonic() + 60
        while (engine.tokens_generated <= tokens_before + 2
               and time.monotonic() < deadline):
            time.sleep(0.002)
        srv.stop()
        srv.join(timeout=0)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


class TestShardedGenerateChaos:
    def test_shard_death_mid_generate_is_retriable_and_leak_free(
            self, stalled_decode):
        """The owning shard's server dies mid-Generate: the caller sees a
        retriable EFAILEDSOCKET naming the shard (not the parallel
        channel's ETOOMANYFAILS), and under the armed ledger every block
        the doomed sequence held comes back."""
        fleet = [_port_shard(n_layers=4, prefix_cache=False)
                 for _ in range(2)]
        try:
            ch = ShardedLlmChannel(_url(fleet), 2, options=ChannelOptions(
                protocol="trpc_std", timeout_ms=60000))
            req = serving_pb2.GenerateRequest(prompt_len=16,
                                              max_new_tokens=200)
            owner = ch.shard_of(req)
            warm = ch.generate(serving_pb2.GenerateRequest(
                prompt_len=16, max_new_tokens=4))
            assert len(warm.tokens) == 4
            killer = _kill_when_decoding(fleet[owner][0], fleet[owner][1],
                                         fleet[owner][1].tokens_generated)
            with pytest.raises(RpcError) as ei:
                ch.generate(req)
            killer.join(10)
            assert ei.value.error_code == errors.EFAILEDSOCKET
            assert "retriable" in str(ei.value)
            assert f"shard {owner}/2" in str(ei.value)
            # the other shard never saw either call (partitioned routing,
            # not fan-out)
            assert fleet[1 - owner][1].tokens_generated == 0
        finally:
            _close_port_fleet(fleet)

    def test_owner_shard_death_with_warm_prefix_leaks_nothing(
            self, stalled_decode):
        """The owner dies mid-Generate while the doomed sequence is forked
        from a committed radix chain: the abort returns only the
        sequence's own holds, and after stop() clears the tree the pool
        is whole."""
        fleet = [_port_shard() for _ in range(2)]
        try:
            ch = ShardedLlmChannel(_url(fleet), 2, options=ChannelOptions(
                protocol="trpc_std", timeout_ms=60000))
            req = serving_pb2.GenerateRequest(prompt_len=48,
                                              max_new_tokens=200)
            owner = ch.shard_of(req)
            owner_engine = fleet[owner][1]
            warms = [ch.generate(serving_pb2.GenerateRequest(
                prompt_len=48, max_new_tokens=4)) for _ in range(2)]
            assert list(warms[0].tokens) == list(warms[1].tokens)
            pfx = owner_engine.snapshot()["prefix"]
            assert pfx["hit_seqs"] >= 1 and pfx["blocks"] > 0, pfx
            killer = _kill_when_decoding(fleet[owner][0], owner_engine,
                                         owner_engine.tokens_generated)
            with pytest.raises(RpcError) as ei:
                ch.generate(req)
            killer.join(10)
            assert ei.value.error_code == errors.EFAILEDSOCKET
            deadline = time.monotonic() + 30.0
            while owner_engine.running_count \
                    and time.monotonic() < deadline:
                time.sleep(0.005)
            assert owner_engine.running_count == 0
            snap = owner_engine.kv.snapshot()
            assert snap["blocks_cached"] > 0
            assert snap["blocks_used"] == snap["blocks_cached"]
        finally:
            _close_port_fleet(fleet)

    def test_fleet_stats_merge_across_shards(self):
        fleet = [_port_shard() for _ in range(2)]
        try:
            ch = ShardedLlmChannel(_url(fleet), 2, options=ChannelOptions(
                protocol="trpc_std", timeout_ms=60000))
            lens = {ch.shard_of(serving_pb2.GenerateRequest(prompt_len=L)):
                    L for L in (16, 32, 48, 64)}
            assert set(lens) == {0, 1}
            for L in lens.values():
                r = ch.generate(serving_pb2.GenerateRequest(
                    prompt_len=L, max_new_tokens=4))
                assert len(r.tokens) == 4
            stats = ch.stats()
            assert stats.tokens_generated == 8
            assert stats.kv_blocks_total == 2 * 64
            cached = sum(e.kv.snapshot()["blocks_cached"]
                         for _s, e, _m, _k in fleet)
            assert stats.kv_blocks_used == cached
            # the merged view is the sum of each shard's own Stats
            for f in StatsMerger.FIELDS:
                want = 0
                for _s, e, _m, _k in fleet:
                    snap = e.kv.snapshot()
                    want += {"seqs_running": e.running_count,
                             "seqs_waiting": e.queue_depth,
                             "kv_blocks_total": snap["blocks_total"],
                             "kv_blocks_used": snap["blocks_used"],
                             "steps": e.steps,
                             "tokens_generated": e.tokens_generated}[f]
                assert getattr(stats, f) == want, f
        finally:
            _close_port_fleet(fleet)


# ----------------------------------------------------- the two-stage router
class TestTwoStageRouter:
    def test_two_stage_dispatch_stitches_the_generation(self):
        """A ShardedLlmChannel over [prefill shard 0, decode shard 1] with
        prefill_partitions=[0] sends stage 1 to the prefill shard, follows
        the handoff to shard 1 and returns ONE stitched response equal to
        the co-located generation."""
        ref = _port_shard(num_blocks=128, max_batch=8, token_budget=512,
                          prefix_cache=False)
        try:
            ch = ShardedLlmChannel(
                f"list://{ref[0].listen_endpoint()} 0/1", 1,
                options=ChannelOptions(timeout_ms=60000))
            ref_toks = list(ch.generate(serving_pb2.GenerateRequest(
                prompt_len=24, max_new_tokens=6)).tokens)
        finally:
            _close_port_fleet([ref])
        pre = _port_shard(num_blocks=128, max_batch=8, token_budget=512,
                          role="prefill", prefix_cache=False)
        dec = _port_shard(num_blocks=128, max_batch=8, token_budget=512,
                          role="decode", prefix_cache=False)
        pre[1].set_migrator(KVMigrator(f"{dec[0].listen_endpoint()}",
                                       dest_shard=1))
        try:
            ch = ShardedLlmChannel(_url([pre, dec]), 2,
                                   options=ChannelOptions(
                                       protocol="trpc_std",
                                       timeout_ms=60000),
                                   prefill_partitions=[0])
            req = serving_pb2.GenerateRequest(prompt_len=24,
                                              max_new_tokens=6)
            assert ch.shard_of(req) == 0  # fresh prompts -> prefill shard
            resp = ch.generate(req)
            assert list(resp.tokens) == ref_toks
            assert resp.prompt_len == 24
            assert resp.steps == len(ref_toks)
            assert resp.finish_reason != "handoff"  # fully stitched
            follow = serving_pb2.GenerateRequest(resume_seq_id=7,
                                                 resume_shard=1)
            assert ch.shard_of(follow) == 1
        finally:
            _close_port_fleet([pre, dec])


# ----------------------------------------- the port fleet against the JAX one
def _jax_shard():
    cfg = JaxModelConfig(attn="reference", n_layers=2, **CFG)
    kv = JaxKV(JaxKVConfig(block_size=16, num_blocks=64), cfg.n_layers,
               cfg.kv_dim)
    kv._check = True
    model = JaxModel(cfg, kv)
    engine = JaxEngine(model, kv, JaxEngineConfig(
        max_batch=4, token_budget=256, idle_wait_s=0.002)).start()
    srv = jax_rpc.Server().add_service(JaxService(engine)).start(
        "127.0.0.1:0")
    return srv, engine, model, kv


def _fleet_requests():
    """The corpus schedule's synth prompts and seeded token prompts (some
    sharing a first block, so the prefix cache forks on the owner)."""
    rng = np.random.default_rng(5)
    shared = [int(t) for t in rng.integers(1, 256, 16)]
    out = [dict(prompt_len=p, max_new_tokens=m) for p, m in SCHEDULE]
    for i in range(8):
        toks = ([int(t) for t in rng.integers(1, 256,
                                              int(rng.integers(2, 40)))]
                if i % 2 else shared + [int(t) for t in rng.integers(
                    1, 256, int(rng.integers(1, 20)))])
        out.append(dict(prompt_tokens=toks,
                        max_new_tokens=int(rng.integers(2, 10))))
    return out


@pytest.mark.parametrize("block_size", [0, 16])
def test_routed_tokens_equal_the_jax_fleet(block_size):
    """The same requests, one at a time, through each package's router
    over two shards: every request lands on the same shard and gets the
    same greedy tokens, bit for bit; each fleet's Stats is the sum of
    its shards'."""
    reqs = _fleet_requests()
    port_fleet = [_port_shard() for _ in range(2)]
    jax_fleet = [_jax_shard() for _ in range(2)]
    try:
        p_ch = ShardedLlmChannel(_url(port_fleet), 2, options=ChannelOptions(
            protocol="trpc_std", timeout_ms=60000), block_size=block_size)
        j_ch = jax_router.ShardedLlmChannel(
            _url(jax_fleet), 2, options=jax_rpc.ChannelOptions(
                protocol="trpc_std", timeout_ms=60000),
            block_size=block_size)
        owners = set()
        for fields in reqs:
            p_req = serving_pb2.GenerateRequest(**fields)
            j_req = jax_pb.GenerateRequest(**fields)
            owner = p_ch.shard_of(p_req)
            assert owner == j_ch.shard_of(j_req), fields
            owners.add(owner)
            before = [e.tokens_generated for _s, e, _m, _k in port_fleet]
            p_resp = p_ch.generate(p_req, controller=Controller())
            j_resp = j_ch.generate(j_req)
            assert list(p_resp.tokens) == [int(t) for t in j_resp.tokens], \
                fields
            assert p_resp.finish_reason == j_resp.finish_reason
            after = [e.tokens_generated for _s, e, _m, _k in port_fleet]
            # only the owner served it
            assert [a - b for a, b in zip(after, before)] == [
                len(p_resp.tokens) if i == owner else 0 for i in range(2)]
        assert owners == {0, 1}
        p_stats, j_stats = p_ch.stats(), j_ch.stats()
        assert p_stats.tokens_generated == j_stats.tokens_generated \
            == sum(e.tokens_generated for _s, e, _m, _k in port_fleet)
        assert p_stats.kv_blocks_total == j_stats.kv_blocks_total == 128
    finally:
        _close_port_fleet(port_fleet)
        for srv, engine, model, kv in jax_fleet:
            srv.stop()
            srv.join(timeout=2)
            engine.stop()
            kv.assert_idle()
            model.close()


def test_routed_generate_bills_the_callers_tenant():
    """A Generate routed by ShardedLlmChannel onto a QoS engine bills the
    caller's ``tenant_id`` on the port. The JAX package's sub-call
    controller carries the deadline only, so the same call through the
    JAX router bills the default lane (a reference fault, ROADMAP Queue
    3)."""
    from brpc_tpu.serving.qos import QosConfig as JaxQosConfig
    from brpc_tpu_torch.serving.qos import DEFAULT_TENANT, QosConfig
    from test_serving import _stub_engine as jax_stub_engine
    from test_torch_qos import _stub_engine as port_stub_engine

    port_eng = port_stub_engine(qos=QosConfig(tenants={"prod": 4.0}))
    jax_eng = jax_stub_engine(qos=JaxQosConfig(tenants={"prod": 4.0}))
    port_srv = Server().add_service(LlmServingService(port_eng)).start(
        "127.0.0.1:0")
    jax_srv = jax_rpc.Server().add_service(JaxService(jax_eng)).start(
        "127.0.0.1:0")
    try:
        p_ch = ShardedLlmChannel(f"list://{port_srv.listen_endpoint()} 0/1",
                                 1)
        j_ch = jax_router.ShardedLlmChannel(
            f"list://{jax_srv.listen_endpoint()} 0/1", 1)
        p_cntl, j_cntl = Controller(), jax_rpc.Controller()
        for c in (p_cntl, j_cntl):
            c.tenant_id, c.priority = "prod", 1
        p = p_ch.generate(serving_pb2.GenerateRequest(
            prompt_len=8, max_new_tokens=2), controller=p_cntl,
            timeout_ms=30000)
        j = j_ch.generate(jax_pb.GenerateRequest(
            prompt_len=8, max_new_tokens=2), controller=j_cntl,
            timeout_ms=30000)
        assert list(p.tokens) == list(j.tokens)
        assert port_eng.qos.snapshot()["tenants"]["prod"]["admitted"] == 1
        jax_tenants = jax_eng.qos.snapshot()["tenants"]
        assert jax_tenants["prod"]["admitted"] == 0
        assert jax_tenants[DEFAULT_TENANT]["admitted"] == 1
    finally:
        for srv in (port_srv, jax_srv):
            srv.stop()
            srv.join(timeout=2)
        for eng in (port_eng, jax_eng):
            eng.stop()
            eng.kv.assert_idle()


def test_launch_counts_are_kept_per_thread():
    """Each shard's engine steps on its own thread, so the launch counter
    keeps each thread's counts beside the total (what the card's router
    phase reads per shard); a reset clears both."""
    from brpc_tpu_torch.tpu.pallas_ops import LaunchCounts

    counts = LaunchCounts()
    idents = {}
    both_alive = threading.Barrier(2)  # so the two idents differ

    def launch(name, n):
        idents[name] = threading.get_ident()
        for _ in range(n):
            counts.add("flash_attention")
        both_alive.wait(30)

    threads = [threading.Thread(target=launch, args=(k, n))
               for k, n in (("a", 3), ("b", 5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert counts["flash_attention"] == 8
    assert counts.of_thread(idents["a"], "flash_attention") == 3
    assert counts.of_thread(idents["b"], "flash_attention") == 5
    assert counts.of_thread(threading.get_ident(), "flash_attention") == 0
    counts.reset()
    assert counts["flash_attention"] == 0
    assert counts.of_thread(idents["b"], "flash_attention") == 0
