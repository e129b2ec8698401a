"""Client-side sharded Generate routing over PartitionChannel.

The port of ``brpc_tpu/serving/router.py``, over the port's
``rpc/combo_channels.PartitionChannel``, ``shard/plane.shard_for`` and
``serving/prefix_cache.prefix_route_key``.

When the serving fleet runs one engine per KV shard (each server owning
one slice of the paged pools), ``Generate`` must land on the shard that
will own the sequence's blocks — a partitioned call, not a fan-out. This
module rides :class:`~brpc_tpu_torch.rpc.combo_channels.PartitionChannel`
(partition_channel.h:46-136 semantics) with a :class:`CallMapper` that
maps each Generate onto exactly ONE partition and ``SKIP``s the rest,
using the same splitmix64 spread (``shard.plane.shard_for``) the
server-side :class:`~brpc_tpu_torch.serving.kv_cache.ShardedKVCache` uses for
block routing — so client routing and block ownership agree by
construction and stay stable under VersionedPool cid reuse.

Failure contract: a sub-call failure during Generate is a SHARD failure,
not a fleet failure. PartitionChannel surfaces it as ETOOMANYFAILS (the
parallel-call verdict); :class:`ShardedLlmChannel` translates that back
to retriable EFAILEDSOCKET so tunnel retry policies back off and retry —
while the owning engine's reap path frees every device-local block the
dead sequence held (under an armed ledger no block leaks).

``Stats`` stays a true fan-out: every shard reports, and
:class:`StatsMerger` sums the per-shard gauges into one fleet view.
"""

from __future__ import annotations

from typing import Optional

from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.channel import ChannelOptions, MethodDescriptor, RpcError
from brpc_tpu_torch.rpc.combo_channels import (SKIP, CallMapper, PartitionChannel,
                                         PartitionParser, ResponseMerger,
                                         SubCall)
from brpc_tpu_torch.rpc.controller import Controller

GENERATE_MD = MethodDescriptor("LlmService", "Generate",
                               serving_pb2.GenerateRequest,
                               serving_pb2.GenerateResponse)
STATS_MD = MethodDescriptor("LlmService", "Stats",
                            serving_pb2.ServingStatsRequest,
                            serving_pb2.ServingStats)


def generate_route_key(request) -> int:
    """Deterministic 64-bit route key for a GenerateRequest: fold the
    prompt (or its synth length) so identical requests land on the same
    shard and the splitmix64 avalanche in ``shard_for`` does the
    spreading — the raw fold does NOT need to be well-distributed."""
    key = 0xCBF29CE484222325
    toks = list(request.prompt_tokens) or [request.prompt_len]
    for t in toks:
        key = ((key ^ (int(t) & 0xFFFFFFFF)) * 0x100000001B3) \
            & 0xFFFFFFFFFFFFFFFF
    return key


def _request_route_key(request, block_size: int) -> int:
    """Prefix-hash route key: fold only the first cached-block-aligned
    window of the prompt (``prefix_route_key``) so every request sharing
    a cacheable first block routes to the shard whose radix tree holds
    the chain — the SAME placement the server's ShardedPrefixCache
    computes. Falls back to ``generate_route_key`` (whole-prompt fold)
    when the prompt cannot hit the cache."""
    from brpc_tpu_torch.serving.prefix_cache import prefix_route_key

    toks = list(request.prompt_tokens)
    key = prefix_route_key(toks, block_size) if toks else None
    return key if key is not None else generate_route_key(request)


class GenerateRouter(CallMapper):
    """Generate -> the owning partition only; everything else fans out.

    The owning partition is ``shard_for(route_key, n)`` — the SAME spread
    the server's ShardedKVCache applies to seq ids, so a fleet whose
    shard i serves KV shard i gets client routing consistent with block
    ownership. With ``block_size`` set, the route key is the prefix hash
    (first cached block of token ids) so same-prefix traffic lands on the
    shard that holds the cached chain."""

    def __init__(self, partition_count: int, block_size: int = 0,
                 prefill_partitions: Optional[list] = None):
        self.partition_count = partition_count
        self.block_size = block_size
        # disaggregated two-stage dispatch: stage-1 Generates (fresh
        # prompts) spread over the prefill partitions only; stage-2
        # (resume_seq_id set) go to the decode shard the handoff named
        self.prefill_partitions = (list(prefill_partitions)
                                   if prefill_partitions else None)

    def route_key(self, request) -> int:
        if self.block_size:
            return _request_route_key(request, self.block_size)
        return generate_route_key(request)

    def owner_of(self, request) -> int:
        from brpc_tpu_torch.shard.plane import shard_for

        if getattr(request, "resume_seq_id", 0):
            return int(request.resume_shard)
        if self.prefill_partitions is not None:
            return self.prefill_partitions[
                shard_for(self.route_key(request),
                          len(self.prefill_partitions))]
        return shard_for(self.route_key(request), self.partition_count)

    def map(self, channel_index: int, method: MethodDescriptor,
            request, response) -> object:
        if method.method_name == "Generate":
            if channel_index != self.owner_of(request):
                return SKIP
        return SubCall(method, request,
                       method.response_class() if method.response_class
                       else None)


class StatsMerger(ResponseMerger):
    """Sum per-shard ServingStats into the fleet view (proto3 MergeFrom
    would overwrite scalars, not add them). The parallel channel runs the
    merger on EVERY successful sub-call, Generate included — a Generate
    has exactly one live sub-call (the owner), so anything that isn't a
    ServingStats copies straight through."""

    FIELDS = ("seqs_running", "seqs_waiting", "kv_blocks_total",
              "kv_blocks_used", "steps", "tokens_generated")

    def merge(self, response, sub_response) -> int:
        if response is None or sub_response is None:
            return self.MERGED
        if not isinstance(sub_response, serving_pb2.ServingStats):
            response.CopyFrom(sub_response)
            return self.MERGED
        for f in self.FIELDS:
            setattr(response, f,
                    getattr(response, f) + getattr(sub_response, f))
        return self.MERGED


class ShardedLlmChannel:
    """Generate/Stats front door for a shard-per-server serving fleet.

    Wraps a PartitionChannel whose naming tags are ``i/n`` (server i owns
    KV shard i of n). ``fail_limit=1``: Generate issues exactly one
    sub-call, so its first failure IS the call's failure — and it comes
    back as EFAILEDSOCKET (retriable), never ETOOMANYFAILS, because the
    caller should treat a dead shard like a dead connection: back off,
    retry, land on the shard's replacement."""

    def __init__(self, ns_url: str, partition_count: int,
                 options: Optional[ChannelOptions] = None,
                 parser: Optional[PartitionParser] = None,
                 block_size: int = 0,
                 prefill_partitions: Optional[list] = None):
        self.partition_count = partition_count
        self._router = GenerateRouter(partition_count,
                                      block_size=block_size,
                                      prefill_partitions=prefill_partitions)
        self._pc = PartitionChannel(fail_limit=1)
        self._pc.init(ns_url, partition_count, parser=parser,
                      options=options,
                      call_mapper=self._router,
                      response_merger=StatsMerger())

    def shard_of(self, request) -> int:
        return self._router.owner_of(request)

    def _call_generate(self, request, cntl):
        try:
            return self._pc.call_method(GENERATE_MD, request,
                                        controller=cntl)
        except RpcError:
            # ONE sub-call was issued (the owner); its failure is a shard
            # failure — retriable, the engine's reap already returned the
            # sequence's device-local blocks
            detail = cntl.error_text()
            cntl.set_failed(
                errors.EFAILEDSOCKET,
                f"shard {self.shard_of(request)}/{self.partition_count} "
                f"failed mid-generate (retriable): {detail}")
            raise RpcError(cntl)

    def generate(self, request,
                 controller: Optional[Controller] = None,
                 timeout_ms: Optional[float] = None,
                 stream_factory=None):
        """One logical generation, any number of physical hops.

        On a disaggregated fleet the prefill shard answers with
        ``finish_reason == "handoff"`` and names the decode shard that
        adopted the sequence (``handoff_shard``/``seq_id``); this follows
        the handoff with a stage-2 resume call and stitches the two
        replies into the response a co-located fleet would have returned:
        tokens concatenated, prompt_len/ttft from the prefill stage,
        steps summed, seq_id/finish_reason from the decode stage.
        ``stream_factory()`` (optional) supplies a fresh stream id per
        hop so TokenDelta frames keep flowing across the handoff."""
        cntl = controller or Controller()
        if timeout_ms is not None:
            cntl.timeout_ms = timeout_ms
        resp = self._call_generate(request, cntl)
        hops = 0
        while (resp is not None and resp.finish_reason == "handoff"
               and hops < 4):
            hops += 1
            follow = serving_pb2.GenerateRequest(
                resume_seq_id=resp.seq_id,
                resume_shard=resp.handoff_shard)
            cntl2 = Controller()
            if timeout_ms is not None:
                cntl2.timeout_ms = timeout_ms
            if stream_factory is not None:
                cntl2.stream_id = stream_factory()
            stage2 = self._call_generate(follow, cntl2)
            stitched = serving_pb2.GenerateResponse(
                tokens=list(resp.tokens) + list(stage2.tokens),
                seq_id=stage2.seq_id,
                prompt_len=resp.prompt_len,
                steps=resp.steps + stage2.steps,
                ttft_us=resp.ttft_us,
                finish_reason=stage2.finish_reason,
                handoff_shard=stage2.handoff_shard)
            resp = stitched
        return resp

    def stats(self, controller: Optional[Controller] = None):
        return self._pc.call_method(
            STATS_MD, serving_pb2.ServingStatsRequest(),
            controller=controller)
