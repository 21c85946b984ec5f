"""gRPC serving endpoint (``tpu.serving.LLMService``) over the port's
engine, a port of the reference package's ``serving/grpc_server.py``.

Unary and server-streaming ``Generate`` with the ensemble tensor
semantics (decoupled deltas, a final-response flag, the stop signal as
RPC cancellation), ``Embed`` for the encoder and ``Health``. The messages
are protoc-generated (``serving/protos``, the same descriptor as the
reference package's, so either side's client talks to either side's
server); the handlers are wired by hand with
``grpc.method_handlers_generic_handler``, which puts the same bytes on the
wire as generated stubs would.

``grpc`` is imported only when a server or a client is built: without
the ``grpcio`` package they raise ``ConfigError``.
"""

from __future__ import annotations

from concurrent import futures
from typing import Iterator

from ..obs import metrics as obs_metrics
from ..utils.errors import ConfigError, EngineError
from ..utils.logging import get_logger
from .protos import llm_service_pb2 as pb

logger = get_logger(__name__)

SERVICE = "tpu.serving.LLMService"


def require_grpc():
    """The ``grpc`` module; ``ConfigError`` naming the package when it
    is not installed."""
    try:
        import grpc
    except ImportError as exc:
        raise ConfigError(
            "the gRPC front end needs the grpcio package, which is not "
            "installed; serve with --grpc-port 0") from exc
    return grpc


def _params_from_request(req, max_output: int):
    """SamplingParams of a ``GenerateRequest``: proto3 zeros mean "unset",
    so an absent field takes the ensemble's default (greedy ``top_k``
    1, ``temperature`` 1.0, 100 tokens)."""
    from ..engine.sampling_params import SamplingParams
    if req.beam_width not in (0, 1):
        raise ValueError("beam_width != 1 is not supported")
    return SamplingParams(
        max_tokens=min(req.max_tokens or 100, max_output),
        temperature=req.temperature if req.temperature else 1.0,
        top_k=req.top_k if req.top_k else 1,
        top_p=req.top_p,
        repetition_penalty=(req.repetition_penalty
                            if req.repetition_penalty else 1.0),
        length_penalty=req.length_penalty if req.length_penalty else 1.0,
        random_seed=req.random_seed,
        stop_words=list(req.stop_words),
        bad_words=list(req.bad_words),
        ignore_eos=req.ignore_eos,
    )


class LLMServicer:
    """Handler implementations (the servicer generated stubs would wrap)."""

    def __init__(self, engine, model_name: str = "model",
                 embed_service=None, max_output: int = 512):
        self.engine = engine
        self.model_name = model_name
        self.embed_service = embed_service
        self.max_output = max_output

    def Health(self, request, context) -> pb.HealthResponse:
        return pb.HealthResponse(ready=True, model_name=self.model_name)

    def _submit(self, request, context):
        self.engine.start()
        try:
            params = _params_from_request(request, self.max_output)
            return self.engine.stream_text(request.text_input, params)
        except (ValueError, EngineError) as exc:
            context.abort(require_grpc().StatusCode.INVALID_ARGUMENT,
                          str(exc))

    def Generate(self, request, context) -> pb.GenerateResponse:
        timer = obs_metrics.RequestTimer("grpc_generate")
        stream = self._submit(request, context)
        # A deadline or a disconnect releases the decode slot instead of
        # generating to max_tokens.
        context.add_callback(stream.cancel)
        try:
            chunks = []
            for chunk in stream:
                timer.token(1)
                chunks.append(chunk)
            return pb.GenerateResponse(
                model_name=self.model_name, text_output="".join(chunks),
                final=True, finish_reason=stream.finish_reason or "")
        finally:
            timer.finish()

    def GenerateStream(self, request, context
                       ) -> Iterator[pb.GenerateResponse]:
        """Decoupled-mode deltas and a final-response marker; the client
        cancelling the RPC is the mid-stream stop signal."""
        timer = obs_metrics.RequestTimer("grpc_generate")
        stream = self._submit(request, context)
        context.add_callback(stream.cancel)   # client hung up -> free slot
        try:
            for chunk in stream:
                timer.token(1)
                yield pb.GenerateResponse(model_name=self.model_name,
                                          text_output=chunk, final=False)
            yield pb.GenerateResponse(
                model_name=self.model_name, text_output="", final=True,
                finish_reason=stream.finish_reason or "")
        finally:
            timer.finish()

    def Embed(self, request, context) -> pb.EmbedResponse:
        if self.embed_service is None:
            context.abort(require_grpc().StatusCode.UNIMPLEMENTED,
                          "no embedder configured")
        texts = list(request.texts)
        if not texts:
            return pb.EmbedResponse(dim=self.embed_service.dim)
        if request.input_type == "query":
            rows = list(self.embed_service.embed_queries(texts))
        else:
            rows = list(self.embed_service.embed_documents(texts))
        flat = [float(x) for row in rows for x in row]
        return pb.EmbedResponse(dim=len(flat) // len(texts), values=flat)


def _handlers(servicer: LLMServicer):
    grpc = require_grpc()
    rpcs = {
        "Health": grpc.unary_unary_rpc_method_handler(
            servicer.Health,
            request_deserializer=pb.HealthRequest.FromString,
            response_serializer=pb.HealthResponse.SerializeToString),
        "Generate": grpc.unary_unary_rpc_method_handler(
            servicer.Generate,
            request_deserializer=pb.GenerateRequest.FromString,
            response_serializer=pb.GenerateResponse.SerializeToString),
        "GenerateStream": grpc.unary_stream_rpc_method_handler(
            servicer.GenerateStream,
            request_deserializer=pb.GenerateRequest.FromString,
            response_serializer=pb.GenerateResponse.SerializeToString),
        "Embed": grpc.unary_unary_rpc_method_handler(
            servicer.Embed,
            request_deserializer=pb.EmbedRequest.FromString,
            response_serializer=pb.EmbedResponse.SerializeToString),
    }
    return grpc.method_handlers_generic_handler(SERVICE, rpcs)


def serve_grpc(engine, model_name: str = "model", embed_service=None,
               max_output: int = 512, host: str = "0.0.0.0",
               port: int = 8001, max_workers: int = 16):
    """Start the gRPC server (non-blocking); returns the ``grpc.Server``,
    its bound port in ``_bound_port`` (``port=0`` binds a free one)."""
    grpc = require_grpc()
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers,
                                   thread_name_prefix="grpc"))
    server.add_generic_rpc_handlers((_handlers(LLMServicer(
        engine, model_name, embed_service, max_output)),))
    bound = server.add_insecure_port(f"{host}:{port}")
    if bound == 0:  # grpc reports bind failure via a 0 port, not an error
        raise OSError(f"gRPC failed to bind {host}:{port} (port in use?)")
    server.start()
    logger.info("gRPC serving %s on %s:%d", model_name, host, bound)
    server._bound_port = bound
    return server


class GrpcLLMClient:
    """Client over the same hand-wired stubs: generation (unary and
    streamed), embedding and readiness polling."""

    def __init__(self, target: str, timeout: float = 120.0):
        grpc = require_grpc()
        self._rpc_error = grpc.RpcError
        self.channel = grpc.insecure_channel(target)
        self.timeout = timeout
        self._generate = self.channel.unary_unary(
            f"/{SERVICE}/Generate",
            request_serializer=pb.GenerateRequest.SerializeToString,
            response_deserializer=pb.GenerateResponse.FromString)
        self._generate_stream = self.channel.unary_stream(
            f"/{SERVICE}/GenerateStream",
            request_serializer=pb.GenerateRequest.SerializeToString,
            response_deserializer=pb.GenerateResponse.FromString)
        self._embed = self.channel.unary_unary(
            f"/{SERVICE}/Embed",
            request_serializer=pb.EmbedRequest.SerializeToString,
            response_deserializer=pb.EmbedResponse.FromString)
        self._health = self.channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString)

    def wait_ready(self, timeout: float = 30.0) -> pb.HealthResponse:
        import time
        deadline = time.monotonic() + timeout
        while True:
            try:
                return self._health(pb.HealthRequest(), timeout=2.0)
            except self._rpc_error:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)

    def generate(self, text: str, **kw) -> str:
        resp = self._generate(pb.GenerateRequest(text_input=text, **kw),
                              timeout=self.timeout)
        return resp.text_output

    def generate_stream(self, text: str, **kw) -> Iterator[str]:
        for resp in self._generate_stream(
                pb.GenerateRequest(text_input=text, **kw),
                timeout=self.timeout):
            if resp.final:
                return
            yield resp.text_output

    def embed(self, texts: list[str], input_type: str = "passage"):
        resp = self._embed(pb.EmbedRequest(texts=texts,
                                           input_type=input_type),
                           timeout=self.timeout)
        import numpy as np
        return np.asarray(resp.values, np.float32).reshape(
            len(texts), resp.dim)

    def close(self) -> None:
        self.channel.close()
