"""gRPC health checking protocol, served builtin on every server.

Counterpart of the reference's ``builtin/grpc_health_check_service.cpp``:
any gRPC client (grpc_health_probe, k8s, Envoy) can call
``/grpc.health.v1.Health/Check`` and get SERVING while the server runs and
NOT_SERVING once it starts logging off.
"""

from __future__ import annotations

from brpc_tpu_torch.proto import health_pb2
from brpc_tpu_torch.rpc.server import Service

HEALTH_DESC = health_pb2.DESCRIPTOR.services_by_name["Health"]


class GrpcHealthService(Service):
    DESCRIPTOR = HEALTH_DESC

    def __init__(self, server):
        super().__init__()
        self._server = server

    def Check(self, cntl, request, done):
        resp = health_pb2.HealthCheckResponse()
        if request.service and self._server.find_service(
                request.service.rpartition(".")[2]) is None:
            resp.status = health_pb2.HealthCheckResponse.SERVICE_UNKNOWN
        elif self._server.is_running:
            resp.status = health_pb2.HealthCheckResponse.SERVING
        else:
            resp.status = health_pb2.HealthCheckResponse.NOT_SERVING
        return resp
