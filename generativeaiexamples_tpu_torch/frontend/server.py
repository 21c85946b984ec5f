"""Frontend app server: static UI + thin API proxy to the chain server (a
port of the reference package's ``frontend/server.py``).

The pages are mounted at ``/content/converse`` and ``/content/kb``; the
browser talks only to this server, and this server talks to the chain
server through ``ChatClient``. Speech (``/api/speech/*``) is on when
``RIVA_API_URI`` names a Riva server and the ``riva.client`` package
imports; otherwise the converse page hides its controls and the routes
answer 501.

    python -m generativeaiexamples_tpu_torch.frontend --port 8090 \
        --chain-server-url http://localhost:8081
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
from typing import Optional

from aiohttp import web

from ..obs import metrics as obs_metrics
from ..serving.streaming import iterate_in_thread
from ..utils.logging import get_logger
from .chat_client import ChatClient

logger = get_logger(__name__)

_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


def _speech_from_env():
    """Build ASR/TTS clients when Riva is configured (RIVA_API_URI), else
    (None, None) — the converse page hides its mic/speaker controls."""
    server = os.environ.get("RIVA_API_URI", "")
    if not server:
        return None, None
    try:
        from .speech import ASRClient, TTSClient
        return ASRClient(server), TTSClient(server)
    except Exception as exc:  # noqa: BLE001 — degrade, don't crash the UI
        logger.warning("speech disabled: %s", exc)
        return None, None


def create_app(client: ChatClient, asr=None, tts=None) -> web.Application:
    app = web.Application(client_max_size=100 * 1024 ** 2)
    uploads: list[dict] = []  # kb page file table (reference: kb.py)
    if asr is None and tts is None:
        asr, tts = _speech_from_env()

    async def index(request: web.Request) -> web.Response:
        raise web.HTTPFound("/content/converse")

    async def converse(request: web.Request) -> web.FileResponse:
        return web.FileResponse(os.path.join(_STATIC, "converse.html"))

    async def kb(request: web.Request) -> web.FileResponse:
        return web.FileResponse(os.path.join(_STATIC, "kb.html"))

    async def api_generate(request: web.Request) -> web.StreamResponse:
        body = await request.json()
        resp = web.StreamResponse(
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"})
        await resp.prepare(request)

        def chunks():
            # Per-request error capture via callback: the shared
            # ChatClient's last_error attribute can be overwritten by a
            # concurrent request's predict() before we'd read it.
            errs: list = []
            for chunk in client.predict(
                    body.get("question", ""),
                    use_knowledge_base=bool(body.get("use_knowledge_base", True)),
                    num_tokens=int(body.get("num_tokens", 256)),
                    context=body.get("context", ""),
                    on_error=errs.append):
                if chunk is None:
                    # predict() filtered any mid-stream error frames out
                    # of the answer text; hand the parsed failure (if
                    # any) to the async side as a typed item.
                    if errs:
                        yield ("__error__", dict(errs[-1]))
                    return
                yield chunk

        try:
            async for chunk in iterate_in_thread(chunks()):
                if isinstance(chunk, tuple):
                    # Partial answer + failure: forward the failure as a
                    # machine-readable event frame, NOT as answer text.
                    _, err = chunk
                    await resp.write(
                        ("\n\nevent: error\ndata: "
                         + json.dumps(err) + "\n\n").encode())
                    continue
                await resp.write(chunk.encode("utf-8"))
        except (ConnectionResetError, ConnectionError):
            pass
        except Exception as exc:  # noqa: BLE001 — surface to the UI
            logger.exception("proxy generate failed")
            await resp.write(
                ("\n\nevent: error\ndata: "
                 + json.dumps({"message": str(exc)}) + "\n\n").encode())
        await resp.write_eof()
        return resp

    async def api_search(request: web.Request) -> web.Response:
        body = await request.json()
        loop = asyncio.get_running_loop()
        try:
            docs = await loop.run_in_executor(
                None, lambda: client.search(body.get("content", ""),
                                            int(body.get("num_docs", 4))))
        except Exception:  # noqa: BLE001 — context pane is best-effort
            docs = []
        return web.json_response(docs)

    async def api_upload(request: web.Request) -> web.Response:
        reader = await request.multipart()
        field = await reader.next()
        while field is not None and field.name != "file":
            field = await reader.next()
        if field is None:
            raise web.HTTPUnprocessableEntity(text="no 'file' field")
        filename = os.path.basename(field.filename or "upload.bin")
        import shutil
        import tempfile
        # Per-upload temp dir: preserves the basename (ChatClient names the
        # upload after it) with no collision between concurrent uploads of
        # the same filename.
        tmp_dir = tempfile.mkdtemp(prefix="gaie-upload-")
        path = os.path.join(tmp_dir, filename)
        with open(path, "wb") as f:
            while True:
                chunk = await field.read_chunk()
                if not chunk:
                    break
                f.write(chunk)
        entry = {"filename": filename, "status": "uploading"}
        uploads.append(entry)
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(
                None, lambda: client.upload_documents([path]))
            entry["status"] = "ingested"
        except Exception as exc:  # noqa: BLE001
            entry["status"] = f"failed: {exc}"
            raise web.HTTPInternalServerError(text=str(exc)) from exc
        finally:
            shutil.rmtree(tmp_dir, ignore_errors=True)
        obs_metrics.REGISTRY.counter(
            "frontend_uploads_total",
            "documents uploaded through the frontend").inc()
        return web.json_response(entry)

    async def api_kb(request: web.Request) -> web.Response:
        return web.json_response(uploads)

    async def health(request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    # Speech: mic transcription + TTS of answers, the converse-page
    # wiring of the reference (reference: frontend/frontend/pages/
    # converse.py:65 builds mic + audio output into the chat page).
    async def api_speech_config(request: web.Request) -> web.Response:
        return web.json_response({"asr": asr is not None,
                                  "tts": tts is not None})

    async def api_transcribe(request: web.Request) -> web.Response:
        if asr is None:
            raise web.HTTPNotImplemented(text="speech not configured "
                                              "(set RIVA_API_URI)")
        audio = await request.read()   # 16 kHz mono 16-bit PCM WAV
        loop = asyncio.get_running_loop()
        try:
            text = await loop.run_in_executor(
                None, lambda: asr.transcribe(audio))
        except Exception as exc:  # noqa: BLE001 — surface to the UI
            raise web.HTTPBadGateway(text=f"asr failed: {exc}") from exc
        return web.json_response({"text": text})

    async def api_tts(request: web.Request) -> web.Response:
        if tts is None:
            raise web.HTTPNotImplemented(text="speech not configured "
                                              "(set RIVA_API_URI)")
        body = await request.json()
        text = str(body.get("text", ""))[:4000]
        loop = asyncio.get_running_loop()
        try:
            audio = await loop.run_in_executor(
                None, lambda: tts.synthesize(text))
        except Exception as exc:  # noqa: BLE001
            raise web.HTTPBadGateway(text=f"tts failed: {exc}") from exc
        return web.Response(body=audio, content_type="audio/wav")

    app.router.add_get("/", index)
    app.router.add_get("/content/converse", converse)
    app.router.add_get("/content/kb", kb)
    app.router.add_static("/static/", _STATIC)
    app.router.add_post("/api/generate", api_generate)
    app.router.add_post("/api/search", api_search)
    app.router.add_post("/api/upload", api_upload)
    app.router.add_get("/api/kb", api_kb)
    app.router.add_get("/api/speech/config", api_speech_config)
    app.router.add_post("/api/speech/transcribe", api_transcribe)
    app.router.add_post("/api/speech/tts", api_tts)
    app.router.add_get("/health", health)
    return app


def main(argv: Optional[list[str]] = None) -> None:
    """CLI: the frontend on ``--host``/``--port`` in front of the chain
    server at ``--chain-server-url`` (default ``$APP_SERVERURL``)."""
    parser = argparse.ArgumentParser(description="RAG frontend")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8090)
    parser.add_argument("--chain-server-url",
                        default=os.environ.get("APP_SERVERURL",
                                               "http://localhost:8081"))
    args = parser.parse_args(argv)
    client = ChatClient(args.chain_server_url)
    logger.info("frontend on %s:%d -> chain server %s",
                args.host, args.port, args.chain_server_url)
    web.run_app(create_app(client), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
