"""rpc — the transport & RPC engine (SURVEY §2.4)."""

from brpc_tpu_torch.rpc import errors
from brpc_tpu_torch.rpc.channel import (Channel, ChannelOptions,
                                  MethodDescriptor, RawMessage, RpcError,
                                  Stub)
from brpc_tpu_torch.rpc.controller import Controller
from brpc_tpu_torch.rpc.server import (GenericService, Server, ServerOptions,
                                 Service)
from brpc_tpu_torch.rpc.socket import Socket
from brpc_tpu_torch.rpc.event_dispatcher import EventDispatcher, global_dispatcher
from brpc_tpu_torch.rpc.input_messenger import InputMessenger

__all__ = [
    "errors",
    "Channel",
    "ChannelOptions",
    "MethodDescriptor",
    "RpcError",
    "Stub",
    "RawMessage",
    "Controller",
    "Server",
    "ServerOptions",
    "Service",
    "GenericService",
    "Socket",
    "EventDispatcher",
    "global_dispatcher",
    "InputMessenger",
]
