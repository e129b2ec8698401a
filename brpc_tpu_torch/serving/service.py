"""LlmService — the serving plane's RPC surface, over the port's engine.

The port of the JAX package's ``serving/service.py``. ``Generate`` is an
async method in the server's dispatch contract: the handler returns None
without calling ``done`` and the engine completes the RPC from its step
loop when generation finishes (or is rejected/aborted). A request that
arrives with stream settings (the client created a stream and set
``cntl.stream_id``) is accepted before admission; TokenDelta frames then
flow per step, one token each, so the client's first token arrives while
the RPC is still in flight. Frame concatenation equals the final
response's token list.

Requests carrying stream settings take the server's full dispatch path,
which is also what stamps ``cntl.deadline_mono`` for the engine's
admission re-check and carries the span the engine annotates with
prefill/decode phases.

Not ported yet: KV migration (ROADMAP Queue 1 item 6), so ``MigrateOpen``
and ``MigrateCommit`` fail with ENOMETHOD and a ``resume_seq_id`` fails
with EREQUEST (no sequence can have migrated in); QoS (item 5), so
``tenant_id`` and ``priority`` are accepted and ignored.
"""

from __future__ import annotations

import numpy as np

from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.server import Service
from brpc_tpu_torch.rpc.stream import StreamOptions, stream_accept
from brpc_tpu_torch.serving.engine import ServingEngine

MIGRATION_NOT_PORTED = ("KV migration is not ported (ROADMAP Queue 1 "
                        "item 6)")


class LlmServingService(Service):
    DESCRIPTOR = serving_pb2.DESCRIPTOR.services_by_name["LlmService"]

    def __init__(self, engine: ServingEngine):
        super().__init__()
        self.engine = engine

    def Generate(self, cntl, request, done):
        if request.resume_seq_id:
            cntl.set_failed(errors.EREQUEST, "no such migrated sequence")
            return serving_pb2.GenerateResponse()
        if request.prompt_tokens:
            prompt = np.asarray(request.prompt_tokens, dtype=np.int32)
        elif request.prompt_len > 0:
            prompt = self.engine.model.synth_prompt(request.prompt_len)
        else:
            cntl.set_failed(errors.EREQUEST,
                            "need prompt_tokens or prompt_len")
            return serving_pb2.GenerateResponse()
        stream_id = 0
        meta = getattr(cntl, "_srv_meta", None)
        if meta is not None and meta.stream_settings.stream_id:
            stream_id = stream_accept(cntl, StreamOptions())
        code, _seq = self.engine.submit(
            prompt, request.max_new_tokens or 16,
            stop_token=request.stop_token, cntl=cntl, done=done,
            stream_id=stream_id)
        if code != 0:
            cntl.set_failed(code, "serving admission rejected")
            return serving_pb2.GenerateResponse()
        return None  # async: the engine's step loop calls done()

    def MigrateOpen(self, cntl, request, done):
        cntl.set_failed(errors.ENOMETHOD, MIGRATION_NOT_PORTED)
        return serving_pb2.MigrateAck()

    def MigrateCommit(self, cntl, request, done):
        cntl.set_failed(errors.ENOMETHOD, MIGRATION_NOT_PORTED)
        return serving_pb2.MigrateAck()

    def Stats(self, cntl, request, done):
        e = self.engine
        kv = e.kv.snapshot()
        return serving_pb2.ServingStats(
            seqs_running=e.running_count, seqs_waiting=e.queue_depth,
            kv_blocks_total=kv["blocks_total"],
            kv_blocks_used=kv["blocks_used"],
            steps=e.steps, tokens_generated=e.tokens_generated)
