"""LlmService — the serving plane's RPC surface, over the port's engine.

The port of the JAX package's ``serving/service.py``. ``Generate`` is an
async method in the server's dispatch contract: the handler returns None
without calling ``done`` and the engine completes the RPC from its step
loop when generation finishes (or is rejected/aborted). A request that
arrives with stream settings (the client created a stream and set
``cntl.stream_id``) is accepted before admission; TokenDelta frames then
flow per step, so the client's first token arrives while the RPC is still
in flight. On a speculative engine (``EngineConfig(spec_k=)``) one step
can commit up to k+1 tokens, so a frame carries a token *list* plus
``accepted``: how many of those tokens were drafted and accepted by the
verifier (the +1 bonus token excluded); other frames carry one token with
``accepted == 0``. Frame concatenation equals the final response's token
list either way.

With the radix prefix cache on (the engine's default), admission matches
the prompt (``prompt_tokens``, or the deterministic ``synth_prompt``
expansion of ``prompt_len``) against cached block chains: a repeated
prefix forks its chain and only the suffix is prefilled, the tokens
those of a cold run.

Requests carrying stream settings take the server's full dispatch path,
which is also what stamps ``cntl.deadline_mono`` for the engine's
admission re-check and carries the span the engine annotates with
prefill/decode phases.

Disaggregated serving: ``MigrateOpen`` and ``MigrateCommit`` are the
destination side of a KV migration (``serving/migration.py``; the
receiver is built at the first call), and a ``Generate`` carrying
``resume_seq_id`` attaches to the sequence a handoff named: no prompt,
no admission, EREQUEST when no such sequence is parked here.

Multi-tenant QoS: ``Generate`` passes the request's ``tenant_id`` and
``priority`` (``RequestMeta``, decoded onto ``cntl`` by the dispatch
path) to the engine, which bills the tenant's fair-share lane and sheds
the best-effort lanes first under overload when it runs with
``EngineConfig(qos=)``.
"""

from __future__ import annotations

import numpy as np

from brpc_tpu_torch.proto import serving_pb2
from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.server import Service
from brpc_tpu_torch.rpc.stream import StreamOptions, stream_accept
from brpc_tpu_torch.serving.engine import ServingEngine


class LlmServingService(Service):
    DESCRIPTOR = serving_pb2.DESCRIPTOR.services_by_name["LlmService"]

    def __init__(self, engine: ServingEngine):
        super().__init__()
        self.engine = engine
        # inbound KV migration, built at the first MigrateOpen or
        # MigrateCommit so co-located deployments never load it
        self._receiver = None

    def Generate(self, cntl, request, done):
        if request.resume_seq_id:
            # stage 2 of the disaggregated dispatch: attach to the
            # migrated sequence (no prompt, no admission, no allocation)
            code, _seq = self.engine.submit(
                np.zeros(0, dtype=np.int32), 0, cntl=cntl, done=done,
                stream_id=self._accept_stream(cntl),
                resume_seq_id=request.resume_seq_id)
            if code != 0:
                cntl.set_failed(code, "no such migrated sequence")
                return serving_pb2.GenerateResponse()
            return None  # async: completion comes from the step loop
        if request.prompt_tokens:
            prompt = np.asarray(request.prompt_tokens, dtype=np.int32)
        elif request.prompt_len > 0:
            prompt = self.engine.model.synth_prompt(request.prompt_len)
        else:
            cntl.set_failed(errors.EREQUEST,
                            "need prompt_tokens or prompt_len")
            return serving_pb2.GenerateResponse()
        code, _seq = self.engine.submit(
            prompt, request.max_new_tokens or 16,
            stop_token=request.stop_token, cntl=cntl, done=done,
            stream_id=self._accept_stream(cntl),
            tenant_id=getattr(cntl, "tenant_id", ""),
            priority=getattr(cntl, "priority", 0))
        if code != 0:
            cntl.set_failed(code, "serving admission rejected")
            return serving_pb2.GenerateResponse()
        return None  # async: the engine's step loop calls done()

    @staticmethod
    def _accept_stream(cntl) -> int:
        """Accept the request's stream if the client created one; 0 if
        not."""
        meta = getattr(cntl, "_srv_meta", None)
        if meta is not None and meta.stream_settings.stream_id:
            return stream_accept(cntl, StreamOptions())
        return 0

    def _migration_receiver(self):
        if self._receiver is None:
            from brpc_tpu_torch.serving.migration import MigrationReceiver

            self._receiver = MigrationReceiver(self.engine)
            self.engine._migration_rx = self._receiver
        return self._receiver

    def MigrateOpen(self, cntl, request, done):
        """Inbound KV migration, phase 1: check the manifest, stage a
        block chain, accept the caller's record stream. The reply only
        says "start streaming"."""
        return self._migration_receiver().open(cntl, request)

    def MigrateCommit(self, cntl, request, done):
        """Inbound KV migration, phase 2: wait until every block is in
        and the sequence adopted (or the transfer failed or timed out).
        The reply IS the adoption ACK the source releases its chain on."""
        return self._migration_receiver().commit(cntl, request)

    def Stats(self, cntl, request, done):
        e = self.engine
        kv = e.kv.snapshot()
        return serving_pb2.ServingStats(
            seqs_running=e.running_count, seqs_waiting=e.queue_depth,
            kv_blocks_total=kv["blocks_total"],
            kv_blocks_used=kv["blocks_used"],
            steps=e.steps, tokens_generated=e.tokens_generated)
