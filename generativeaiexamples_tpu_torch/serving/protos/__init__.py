"""Generated protobuf messages for the gRPC serving surface.

``llm_service_pb2.py`` is generated from ``llm_service.proto`` with plain
``protoc --python_out``; the service's handlers are built with grpc's
generic handlers instead of generated stubs (see serving/grpc_server.py).
"""

from . import llm_service_pb2  # noqa: F401
