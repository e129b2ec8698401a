"""Combo channels — fan-out, selection, and partitioning over sub-channels.

Rebuild of the reference's ParallelChannel (parallel_channel.cpp:580 +
aggregated done :40), SelectiveChannel (selective_channel.cpp; LB over
channels with retry-on-another), and PartitionChannel (partition_channel.h:
46-136; NS tags parsed into partition membership).

The port's copy of ``brpc_tpu/rpc/combo_channels.py``. These are the
RPC-level combo semantics; when every sub-target is a local device
(``tpu://host/n`` endpoints with distinct ordinals this process has) the
same fan-out LOWERS onto the mesh collectives:
ParallelChannel.call_tensor detects the all-device sub-channel set
(device_mesh), runs the fan-out + merge as ONE program over a port
``Mesh`` of those devices (``tpu/collective.fanout_call``), and falls
back to one CollectiveService.Apply RPC per sub-channel with a host-side
merge otherwise. Two meshes can carry it: while rank 0 of a launched
rank mesh (``tpu/launch.py``) holds it, sub-channels ``tpu://host/0 ..
n-1`` name its n ranks' devices, and the program runs over the ranks
(each sub-channel's shard on its own rank, the merge a collective on
the world group; the registered fn goes to the workers by pickle, so it
is a module-level function); otherwise the replayed mesh lies on one
device, so the lowering takes ``use_cpu(n)``'s n CPU positions or ONE
card, every position replayed in this process, and eight sub-channels
on one card name ordinal 0 eight times and take the RPC path.
PartitionChannel inherits the same lowering (gather merge ==
results stay partitioned, partition_channel.h:46-136 semantics).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.channel import (Channel, ChannelOptions,
                                        MethodDescriptor, RpcError)
from brpc_tpu_torch.rpc.controller import Controller

SKIP = object()  # CallMapper return: leave this sub-channel out


# --------------------------------------------------------------------------
# Collective lowering (SURVEY §2.5): when every sub-channel of a
# ParallelChannel targets a LOCAL tpu:// device, the fan-out + merge runs
# as ONE program over a mesh built from exactly those devices
# (tpu/collective.fanout_call) — the request tensor shards over the fan
# axis, the registered fn runs per shard, and the merger IS the
# collective (sum -> psum, gather -> sharded assembly). Reference
# semantic spec: parallel_channel.cpp:580 (same request to N replicas,
# responses merged). When detection fails, the SAME call issues one
# CollectiveService.Apply RPC per sub-channel through the device-method
# lane and merges host-side; a test asserts the two executions agree.
# --------------------------------------------------------------------------
_collective_method_registered = False


def _ensure_collective_device_method() -> None:
    global _collective_method_registered
    if _collective_method_registered:
        return
    _collective_method_registered = True
    from brpc_tpu_torch.tpu.tpusocket import register_device_method

    register_device_method("CollectiveService", "Apply",
                           _device_collective_apply)


def _device_collective_apply(device, meta, payload: bytes,
                             attachment: bytes):
    """Device method behind the RPC fallback: apply a registered
    collective fn to the shard on the addressed device (a torch tensor
    there; the result comes back to the host)."""
    import numpy as np
    import torch

    from brpc_tpu_torch.proto import collective_pb2
    from brpc_tpu_torch.tpu import collective as _coll

    req = collective_pb2.TensorRequest()
    req.ParseFromString(payload)
    try:
        fn = _coll.collective_fn(req.fn)
    except KeyError:
        return errors.ENOMETHOD, b"", b""
    arr = np.frombuffer(req.data, dtype=np.dtype(req.dtype)).reshape(
        tuple(req.shape))
    y = fn(torch.from_numpy(arr.copy()).to(device)).cpu().numpy()
    resp = collective_pb2.TensorResponse(
        dtype=str(y.dtype), shape=list(y.shape),
        data=np.ascontiguousarray(y).tobytes())
    return errors.OK, resp.SerializeToString(), b""


def _sub_controller(cntl: Controller) -> Controller:
    """A sub-call's controller: the caller's deadline and its QoS identity
    (``tenant_id`` / ``priority``), so a routed call bills the tenant's
    lane on the server it lands on. The JAX package's sub-controllers
    carry the deadline only (ROADMAP Queue 3)."""
    sub = Controller()
    sub.timeout_ms = cntl.timeout_ms
    sub.tenant_id = cntl.tenant_id
    sub.priority = cntl.priority
    return sub


class CollectiveScheme:
    """How a tensor fan-out should execute: the fn (registered by name so
    BOTH paths — the shard_map program and the per-device RPC — resolve
    it) and the merge mode ('gather' concatenates sub-responses in
    sub-channel order, 'sum' psums into one response)."""

    def __init__(self, fn_name: str, fn: Callable = None,
                 merge: str = "gather", axis_name: str = "fan"):
        if merge not in ("gather", "sum"):
            raise ValueError(f"unknown merge {merge!r}")
        if fn is not None:
            from brpc_tpu_torch.tpu import collective as _coll

            _coll.register_collective_fn(fn_name, fn)
        self.fn_name = fn_name
        self.merge = merge
        self.axis_name = axis_name
        _ensure_collective_device_method()


@dataclass
class SubCall:
    method: MethodDescriptor
    request: object
    response: object


class CallMapper:
    """Maps the main call onto one sub-channel's call
    (parallel_channel.h:94). Default: same method/request, fresh response."""

    def map(self, channel_index: int, method: MethodDescriptor,
            request, response) -> object:
        return SubCall(method, request,
                       method.response_class() if method.response_class
                       else None)


class ResponseMerger:
    """Folds one sub-response into the main response
    (parallel_channel.h:127). Default: the message's MergeFrom.

    merge() returns MERGED (0) on success, FAIL to count the sub-call as one
    failure against fail_limit, or FAIL_ALL to fail the whole parallel call
    (reference parallel_channel.h:128-140 Result enum).
    """

    MERGED = 0
    FAIL = 1
    FAIL_ALL = 2

    def merge(self, response, sub_response) -> int:
        if response is not None and sub_response is not None:
            response.MergeFrom(sub_response)
        return self.MERGED


class ParallelChannel:
    """One RPC -> all sub-channels concurrently; responses merged.

    Reference semantics (parallel_channel.h:161-174, .cpp:223-235):

    - ``fail_limit`` (default: number of issued sub-calls; clamped to
      [1, issued] like the reference .cpp:661-667): the call fails as soon
      as this many sub-calls failed; remaining sub-calls are canceled
      (ECANCELED) and the whole call completes immediately.
    - ``success_limit`` (only honored when fail_limit is unset): the call
      completes successfully as soon as this many sub-calls succeeded;
      remaining sub-calls are canceled with EPCHANFINISH, which is not
      counted as a sub-call error. Note it is an early-RETURN knob, not a
      quorum: like the reference, if the fan-out exhausts with fewer
      successes (but not every sub-call failed) the call still succeeds.
    """

    def __init__(self, fail_limit: Optional[int] = None,
                 success_limit: Optional[int] = None):
        self._subs: List[Tuple[Channel, CallMapper, ResponseMerger]] = []
        self.fail_limit = fail_limit
        self.success_limit = success_limit if fail_limit is None else None

    def add_channel(self, channel: Channel,
                    call_mapper: Optional[CallMapper] = None,
                    response_merger: Optional[ResponseMerger] = None) -> None:
        self._subs.append((channel,
                           call_mapper or CallMapper(),
                           response_merger or ResponseMerger()))

    def channel_count(self) -> int:
        return len(self._subs)

    # ----------------------------------------------- collective lowering
    def device_mesh(self, axis_name: str = "fan"):
        """A Mesh over the sub-channels' devices — iff EVERY sub-channel
        targets a local tpu:// endpoint (tpu://host/ordinal, no port) with
        a distinct ordinal, and either the ordinals are 0 .. n-1 in order
        and this process is rank 0 of a launched n-rank mesh (a 1-axis
        view over its ranks), or the replayed mesh can lay them (one
        device: ``use_cpu(n)``'s CPU positions, or one card). None
        otherwise (the RPC fallback runs)."""
        from brpc_tpu_torch.tpu import launch as _launch
        from brpc_tpu_torch.tpu import mesh as _mesh

        eps = []
        for channel, _m, _g in self._subs:
            ep = getattr(channel, "_remote", None)
            if ep is None or getattr(ep, "device_ordinal", -1) < 0 \
                    or ep.port:
                return None
            eps.append(ep)
        ords = [ep.device_ordinal for ep in eps]
        if not ords or len(set(ords)) != len(ords):
            return None
        group = _launch.active()
        if group is not None and ords == list(range(group.world)):
            return _launch.comm().mesh({axis_name: group.world})
        try:
            devs = [_mesh.resolve_device(ep) for ep in eps]
            return _mesh.make_mesh({axis_name: len(devs)}, devices_list=devs)
        except (ValueError, RuntimeError):
            return None

    def call_tensor(self, x, scheme: CollectiveScheme):
        """Tensor fan-out: x shards over dim 0 across the sub-channels.
        All-device sub-channel sets execute as ONE program over their mesh
        (tpu/collective.fanout_call) and return a tensor on the mesh's
        device; anything else falls back to one CollectiveService.Apply
        RPC per sub-channel + host-side merge, returning numpy. Both paths
        return the same values (tested equal). Over a rank mesh the
        program runs on the ranks and its result lands on rank 0's
        device."""
        mesh = self.device_mesh(scheme.axis_name)
        if mesh is not None:
            import torch

            from brpc_tpu_torch.tpu import collective as _coll

            fn = _coll.collective_fn(scheme.fn_name)
            xt = torch.as_tensor(x).to(mesh.device)
            return _coll.fanout_call(fn, mesh, scheme.axis_name,
                                     scheme.merge, xt)
        return self._call_tensor_rpc(x, scheme)

    def _call_tensor_rpc(self, x, scheme: CollectiveScheme):
        import numpy as np

        import torch

        from brpc_tpu_torch.proto import collective_pb2

        n = len(self._subs)
        xa = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        if n == 0:
            raise ValueError("no sub-channels")
        if xa.shape[0] % n:
            raise ValueError(
                f"dim 0 ({xa.shape[0]}) must divide over {n} sub-channels")
        shards = np.split(xa, n, axis=0)
        md = MethodDescriptor("CollectiveService", "Apply",
                              collective_pb2.TensorRequest,
                              collective_pb2.TensorResponse)
        outs: List = [None] * n
        fails: List = []

        def one(i, channel, shard):
            req = collective_pb2.TensorRequest(
                fn=scheme.fn_name, dtype=str(shard.dtype),
                shape=list(shard.shape),
                data=np.ascontiguousarray(shard).tobytes())
            try:
                resp = channel.call_method(md, req)
                outs[i] = np.frombuffer(
                    resp.data, dtype=np.dtype(resp.dtype)).reshape(
                        tuple(resp.shape))
            except Exception as e:  # noqa: BLE001 — joined below
                fails.append(e)

        threads = [threading.Thread(target=one, args=(i, ch, sh),
                                    name=f"combo-shard-{i}")
                   for i, ((ch, _m, _g), sh) in enumerate(zip(self._subs,
                                                              shards))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if fails:
            raise fails[0]
        if scheme.merge == "sum":
            out = outs[0].astype(outs[0].dtype, copy=True)
            for o in outs[1:]:
                out = out + o
            return out
        return np.concatenate(outs, axis=0)

    def call_method(self, method: MethodDescriptor, request, response=None,
                    controller: Optional[Controller] = None, done=None):
        cntl = controller or Controller()
        if response is None and method.response_class is not None:
            response = method.response_class()
        cntl._response = response
        subs = list(self._subs)
        mapped = []
        for idx, (channel, mapper, merger) in enumerate(subs):
            sub = mapper.map(idx, method, request, response)
            if sub is SKIP or sub is None:
                continue
            mapped.append((channel, merger, sub))
        # limits count ISSUED sub-calls; skipped ones can't fail. Clamp to
        # [1, issued] (reference .cpp:661-678) so fail_limit > issued can't
        # turn an all-fail fan-out into a silent empty success.
        fail_limit = self.fail_limit if self.fail_limit else len(mapped)
        fail_limit = max(1, min(fail_limit, len(mapped))) if mapped else 1
        success_limit = (self.success_limit
                         if self.fail_limit is None and self.success_limit
                         else len(mapped))
        success_limit = (max(1, min(success_limit, len(mapped)))
                         if mapped else 1)
        if not mapped:
            cntl.set_failed(errors.EREQUEST, "all sub-calls skipped")
            if done is not None:
                done(cntl)
                return cntl
            raise RpcError(cntl)

        state = {
            "pending": len(mapped),
            "failed": 0,
            "succeeded": 0,
            "first_error": None,
            "finished": False,
            "sub_cntls": [],
            "lock": threading.Lock(),
            "event": threading.Event(),
        }
        merge_lock = threading.Lock()

        def cancel_sub(sc, code: int) -> None:
            from brpc_tpu_torch.rpc.controller import _fire_id_error

            cid = sc.call_id()
            if cid is not None:
                try:
                    _fire_id_error(cid, code)
                except Exception:
                    pass

        def cancel_outstanding(code: int) -> None:
            """Cancel sub-calls still in flight once a limit decides the
            outcome (reference .cpp:230-240 bthread_id_error fanout)."""
            for sc in state["sub_cntls"]:
                cancel_sub(sc, code)

        def finish(cancel_code: Optional[int] = None):
            # merge_lock serializes with in-flight merger.merge() calls: a
            # failure-path finish must not run done() while another sub_done
            # is still writing into the caller's response
            with merge_lock:
                if state["failed"] >= fail_limit:
                    code, text = state["first_error"]
                    cntl.set_failed(
                        errors.ETOOMANYFAILS,
                        f"{state['failed']}/{len(mapped)} sub-calls "
                        f"failed, first: [E{code}] {text}")
                if cancel_code is not None:
                    cancel_outstanding(cancel_code)
                state["event"].set()
                if done is not None:
                    try:
                        done(cntl)
                    except Exception:
                        pass

        def make_done(merger, sub):
            def sub_done(sub_cntl):
                merge_rc = ResponseMerger.MERGED
                sub_err = sub_cntl.failed()
                # EPCHANFINISH = we finished early on success_limit; not an
                # error of the sub-call (reference .cpp:220-221)
                canceled_by_finish = (sub_err and sub_cntl.error_code
                                      == errors.EPCHANFINISH)
                if not sub_err:
                    with merge_lock:
                        if not state["finished"]:
                            try:
                                merge_rc = merger.merge(
                                    response, sub_cntl.response)
                                merge_rc = (ResponseMerger.MERGED
                                            if merge_rc is None else merge_rc)
                            except Exception:
                                # a merger that THROWS may have left the main
                                # response partially mutated — same poison the
                                # reference's default-merger catch treats as
                                # whole-call failure (.cpp:317-321); mergers
                                # signal per-sub failure by returning FAIL
                                merge_rc = ResponseMerger.FAIL_ALL
                with state["lock"]:
                    if state["finished"]:
                        return
                    if merge_rc == ResponseMerger.FAIL_ALL:
                        # merger demands the whole call fail
                        state["failed"] = len(mapped)
                        fail_all = True
                        if state["first_error"] is None:
                            state["first_error"] = (
                                errors.ERESPONSE, "response merger FAIL_ALL")
                    else:
                        fail_all = False
                        if ((sub_err and not canceled_by_finish)
                                or merge_rc != ResponseMerger.MERGED):
                            # a merger FAIL counts against fail_limit
                            # (parallel_channel.h:132-136)
                            state["failed"] += 1
                            if state["first_error"] is None:
                                if sub_err:
                                    state["first_error"] = (
                                        sub_cntl.error_code,
                                        sub_cntl.error_text())
                                else:
                                    state["first_error"] = (
                                        errors.ERESPONSE,
                                        f"response merger failed ({merge_rc})")
                        elif not sub_err:
                            state["succeeded"] += 1
                    state["pending"] -= 1
                    cancel_code = None
                    if fail_all or state["failed"] >= fail_limit:
                        cancel_code = errors.ECANCELED
                    elif state["succeeded"] >= success_limit:
                        cancel_code = errors.EPCHANFINISH
                    if cancel_code is None and state["pending"] > 0:
                        return
                    state["finished"] = True
                finish(cancel_code if state["pending"] > 0 else None)

            return sub_done

        for channel, merger, sub in mapped:
            with state["lock"]:
                # an inline sub-call failure can finish the whole call while
                # we are still issuing — don't launch sub-calls the finish
                # already "canceled" (they were never in sub_cntls)
                if state["finished"]:
                    break
                sub_cntl = _sub_controller(cntl)
                state["sub_cntls"].append(sub_cntl)
            channel.call_method(sub.method, sub.request,
                                response=sub.response,
                                controller=sub_cntl,
                                done=make_done(merger, sub))
            with state["lock"]:
                raced = state["finished"]
            if raced:
                # finish() ran during this call_method; its cancel fanout may
                # have missed this freshly-created id — cancel it directly
                cancel_sub(sub_cntl, errors.ECANCELED)
        if done is not None:
            return cntl
        state["event"].wait()
        if cntl.failed():
            raise RpcError(cntl)
        return response


class SelectiveChannel:
    """LB over channels: each call picks one healthy sub-channel; a failed
    call retries on a different one (selective_channel.cpp semantics — each
    sub-channel acts like one "server" with parking on failure streaks)."""

    def __init__(self, max_retry: int = 3):
        self._subs: List[Channel] = []
        self._states: List[object] = []  # shared _NodeState machinery
        self._rr = 0
        self._lock = threading.Lock()
        self.max_retry = max_retry

    def add_channel(self, channel: Channel) -> int:
        from brpc_tpu_torch.policy.load_balancers import _NodeState

        with self._lock:
            self._subs.append(channel)
            self._states.append(_NodeState())
            return len(self._subs) - 1

    def _pick(self) -> Optional[int]:
        with self._lock:
            n = len(self._subs)
            for off in range(n):
                idx = (self._rr + off) % n
                if not self._states[idx].is_down:
                    self._rr = idx + 1
                    return idx
            if n:  # all parked: least-recently-parked anyway
                return min(range(n),
                           key=lambda i: self._states[i].down_until)
        return None

    def call_method(self, method: MethodDescriptor, request, response=None,
                    controller: Optional[Controller] = None, done=None):
        """Sync when done is None; async otherwise (the retry loop runs on
        a fiber worker and done fires on completion — same contract as
        Channel.call_method)."""
        cntl = controller or Controller()
        if response is None and method.response_class is not None:
            response = method.response_class()

        def run_attempts():
            import time as _time

            last_err = None
            for _ in range(1 + self.max_retry):
                idx = self._pick()
                if idx is None:
                    cntl.set_failed(errors.EHOSTDOWN, "no sub-channels")
                    break
                sub_cntl = _sub_controller(cntl)
                # each attempt gets an ISOLATED response: a failed attempt
                # that partially filled its response must not leak state
                # into the next attempt or the caller's object (reference
                # selective_channel.cpp sub-call isolation)
                sub_resp = (method.response_class()
                            if method.response_class else None)
                start = _time.perf_counter_ns() // 1000
                try:
                    out = self._subs[idx].call_method(
                        method, request, response=sub_resp,
                        controller=sub_cntl)
                except RpcError as e:
                    self._states[idx].on_feedback(
                        e.error_code,
                        _time.perf_counter_ns() // 1000 - start)
                    last_err = e
                    continue
                self._states[idx].on_feedback(
                    errors.OK, _time.perf_counter_ns() // 1000 - start)
                if response is not None and out is not None \
                        and out is not response:
                    response.CopyFrom(out)
                    out = response
                cntl._response = out
                return out
            if last_err is not None and not cntl.failed():
                cntl.set_failed(last_err.error_code, str(last_err))
            return None

        if done is not None:
            from brpc_tpu_torch.fiber import runtime

            def run_async():
                run_attempts()
                try:
                    done(cntl)
                except Exception:
                    pass

            runtime.start_background(run_async)
            return cntl
        out = run_attempts()
        if cntl.failed():
            raise RpcError(cntl)
        return out


class PartitionParser:
    """Extract (partition_index, partition_count) from a server tag.

    Default syntax 'i/n' (reference example: tag "1/3" = partition 1 of 3).
    Return None to drop the server.
    """

    def parse(self, tag: str) -> Optional[Tuple[int, int]]:
        try:
            idx, _, cnt = tag.partition("/")
            return int(idx), int(cnt)
        except ValueError:
            return None


class PartitionChannel(ParallelChannel):
    """Shards one naming-service server list into N partitions; each call
    fans out one sub-call per partition (partition_channel.h:46-136)."""

    def __init__(self, fail_limit: Optional[int] = None,
                 success_limit: Optional[int] = None):
        super().__init__(fail_limit=fail_limit, success_limit=success_limit)
        self._partition_lbs = []
        self._ns_thread = None

    def init(self, ns_url: str, partition_count: int,
             parser: Optional[PartitionParser] = None,
             lb_name: str = "rr",
             options: Optional[ChannelOptions] = None,
             call_mapper: Optional[CallMapper] = None,
             response_merger: Optional[ResponseMerger] = None,
             ) -> "PartitionChannel":
        from brpc_tpu_torch.policy.load_balancers import create_load_balancer
        from brpc_tpu_torch.policy.naming import start_naming_service

        parser = parser or PartitionParser()
        self._partition_lbs = [create_load_balancer(lb_name)
                               for _ in range(partition_count)]

        class _Splitter:
            """Naming listener that routes each node to its partition LB."""

            def reset_servers(splitter, nodes):
                groups = [[] for _ in range(partition_count)]
                for node in nodes:
                    parsed = parser.parse(node.tag)
                    if parsed is None:
                        continue
                    idx, cnt = parsed
                    if cnt == partition_count and 0 <= idx < cnt:
                        groups[idx].append(node)
                for lb, group in zip(self._partition_lbs, groups):
                    lb.reset_servers(group)

        self._ns_thread = start_naming_service(ns_url, _Splitter())
        for lb in self._partition_lbs:
            sub = Channel(options or ChannelOptions())
            sub._protocol = None  # init below
            sub.init_with_lb(lb)
            self.add_channel(sub, call_mapper=call_mapper,
                             response_merger=response_merger)
        return self


class DynamicPartitionChannel:
    """Capacity-weighted migration between partition schemes (reference
    partition_channel.h:136 + policy/dynpart_load_balancer.cpp).

    Servers tagged ``i/n`` group themselves by ``n`` into SCHEMES; each
    scheme is a full PartitionChannel-style fan-out. A call picks ONE
    scheme, weighted-random by the scheme's capacity (its server count —
    the reference's dynpart LB weights sub-channels the same way,
    dynpart_load_balancer.cpp:101-156), then fans out over that scheme's
    partitions. Deploying a 4-partition tier next to a 2-partition tier
    shifts traffic toward the new tier as its instances register; draining
    the old tier finishes the migration with zero client changes.

    The TPU mapping (SURVEY §2.5): schemes are shardings; capacity-weighted
    scheme choice is re-sharding between device meshes while both are live.
    """

    def __init__(self, fail_limit: Optional[int] = None,
                 success_limit: Optional[int] = None):
        self.fail_limit = fail_limit
        self.success_limit = success_limit
        self._schemes: dict = {}      # partition_count -> _Scheme
        self._lock = threading.Lock()
        self._ns_thread = None
        self._parser = None
        self._lb_name = "rr"
        self._options = None
        self._call_mapper = None
        self._response_merger = None

    class _Scheme:
        """One partition scheme: n per-partition LBs + a ParallelChannel
        fanning out over them. capacity = total servers registered."""

        def __init__(self, owner: "DynamicPartitionChannel", count: int):
            from brpc_tpu_torch.policy.load_balancers import create_load_balancer

            self.count = count
            self.capacity = 0
            self.lbs = [create_load_balancer(owner._lb_name)
                        for _ in range(count)]
            self.fanout = ParallelChannel(fail_limit=owner.fail_limit,
                                          success_limit=owner.success_limit)
            for lb in self.lbs:
                sub = Channel(owner._options or ChannelOptions())
                sub.init_with_lb(lb)
                self.fanout.add_channel(sub,
                                        call_mapper=owner._call_mapper,
                                        response_merger=owner._response_merger)

        def reset(self, groups) -> None:
            self.capacity = sum(len(g) for g in groups)
            for lb, group in zip(self.lbs, groups):
                lb.reset_servers(group)

    def init(self, ns_url: str, parser: Optional[PartitionParser] = None,
             lb_name: str = "rr", options: Optional[ChannelOptions] = None,
             call_mapper: Optional[CallMapper] = None,
             response_merger: Optional[ResponseMerger] = None,
             ) -> "DynamicPartitionChannel":
        from brpc_tpu_torch.policy.naming import start_naming_service

        self._parser = parser or PartitionParser()
        self._lb_name = lb_name
        self._options = options
        self._call_mapper = call_mapper
        self._response_merger = response_merger
        self._ns_thread = start_naming_service(ns_url, self._listener())
        return self

    def _listener(self):
        outer = self

        class _Grouper:
            def reset_servers(listener, nodes):
                by_count: dict = {}
                for node in nodes:
                    parsed = outer._parser.parse(node.tag)
                    if parsed is None:
                        continue
                    idx, cnt = parsed
                    if cnt <= 0 or not 0 <= idx < cnt:
                        continue
                    by_count.setdefault(cnt, [[] for _ in range(cnt)])
                    by_count[cnt][idx].append(node)
                with outer._lock:
                    for cnt, groups in by_count.items():
                        scheme = outer._schemes.get(cnt)
                        if scheme is None:
                            scheme = outer._schemes[cnt] = \
                                DynamicPartitionChannel._Scheme(outer, cnt)
                        scheme.reset(groups)
                    for cnt in list(outer._schemes):
                        if cnt not in by_count:
                            # scheme fully drained: drop it
                            outer._schemes.pop(cnt)

        return _Grouper()

    # ------------------------------------------------------------- calling
    def _pick_scheme(self):
        from brpc_tpu_torch.butil.misc import fast_rand_less_than

        with self._lock:
            schemes = [s for s in self._schemes.values() if s.capacity > 0]
        if not schemes:
            return None
        total = sum(s.capacity for s in schemes)
        r = fast_rand_less_than(total)
        acc = 0
        for s in schemes:
            acc += s.capacity
            if r < acc:
                return s
        return schemes[-1]

    def scheme_capacities(self) -> dict:
        with self._lock:
            return {cnt: s.capacity for cnt, s in self._schemes.items()}

    def call_method(self, method, request, response=None,
                    controller: Optional[Controller] = None, done=None):
        scheme = self._pick_scheme()
        if scheme is None:
            cntl = controller or Controller()
            cntl._response = response
            cntl.set_failed(errors.EHOSTDOWN,
                            "no partition scheme has servers")
            if done is not None:
                done(cntl)
                return cntl
            raise RpcError(cntl)
        cntl = controller or Controller()
        cntl.partition_count = scheme.count  # observable routing decision
        return scheme.fanout.call_method(method, request, response=response,
                                         controller=cntl, done=done)
