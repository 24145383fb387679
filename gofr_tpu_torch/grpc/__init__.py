"""gRPC entrypoint (gofr `pkg/gofr/grpc.go` + `pkg/gofr/grpc/log.go`), the
port's own copy of gofr_tpu/grpc/__init__.py.

Unlike the reference — where gRPC handlers bypass the framework Context
(SURVEY.md §3.3 notes the asymmetry) — servicers registered here can access the
full Context: the logging interceptor opens a span and exposes
``current_grpc_context()`` carrying the container, so gRPC methods get the same
datasource/tracing/inference surface as HTTP handlers.
"""

from gofr_tpu_torch.grpc.server import GofrGrpcInterceptor, current_grpc_context, start_grpc_server

__all__ = ["start_grpc_server", "GofrGrpcInterceptor", "current_grpc_context"]
