"""OpenAI-compatible HTTP service on the standard library.

Mirrors the reference HTTP service (reference: lib/llm/src/http/service/
service_v2.rs:24-90, openai.rs:132,214, service.rs:58 ModelManager): models
attach/detach dynamically; requests always stream internally and are
aggregated for ``stream=false``; SSE framing with a final ``data: [DONE]``.

Port of ``dynamo_tpu/llm/http/service.py``, which stands on aiohttp; this one
stands on ``asyncio.start_server`` and parses HTTP/1.1 itself: the request
line, headers (``Expect: 100-continue`` answered) and a ``Content-Length``
body, with keep-alive. Streams go out as ``text/event-stream``, chunked to an
HTTP/1.1 client and close-delimited to an HTTP/1.0 one. Same routes, JSON
bodies, SSE events and errors as the reference: ``POST /v1/chat/completions``
and ``/v1/completions`` (unary and ``stream: true``), ``GET /v1/models``,
``/health``, ``/live``, ``/ready`` and ``/metrics``; 400 on invalid JSON or a
protocol error, 404 ``model_not_found``, 400 ``context_length_exceeded``
before any SSE byte. A client that disconnects mid-stream cancels its engine
request.

Multi-tenant QoS admission (``utils/qos.py``), before any SSE byte: the
class comes from ``x-priority`` (strictly parsed: an unknown class is a 400
``invalid_priority``) or else the policy's default for the ``x-tenant``
tenant and the model's adapter; batch-class requests are shed with a 429
``overloaded`` while the engine's estimated queue wait exceeds the policy's
``shed_wait_s``; a tenant whose token budget cannot hold prompt +
``max_tokens`` gets a 429 ``rate_limited``. Both 429s carry
``Retry-After``. The class and tenant ride the preprocessed request to the
engine, and ``/metrics`` renders the ``dynamo_qos_*`` families.

Left out with the planes they need (not ported): the admission fault knob,
the draining 503, readiness from the engine's health and the engine's
metric families on ``/metrics``, SLO and goodput tracking (the shed budget
is the policy's, not a TTFT target), the events journal, ``/trace`` and
``/debug/*``.
"""

from __future__ import annotations

import asyncio
import json
import time
from http import HTTPStatus
from typing import AsyncIterator, Optional
from urllib.parse import urlsplit

from dynamo_tpu_torch.llm.http.metrics import Metrics
from dynamo_tpu_torch.llm.protocols import sse
from dynamo_tpu_torch.llm.protocols.aggregator import (
    aggregate_chat_stream,
    aggregate_completion_stream,
)
from dynamo_tpu_torch.llm.protocols.openai import (
    ChatCompletionRequest,
    ChatDeltaGenerator,
    CompletionDeltaGenerator,
    CompletionRequest,
    ProtocolError,
    Usage,
)
from dynamo_tpu_torch.llm.tools import ToolCallError, ToolCallingMatcher
from dynamo_tpu_torch.runtime.context import new_context, use_context
from dynamo_tpu_torch.utils import get_logger
from dynamo_tpu_torch.utils.qos import AdmissionController, QosPolicy, parse_priority

log = get_logger("http")

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024


class ModelPipeline:
    """Everything needed to serve one model, on both endpoints:
    preprocessor + backend."""

    def __init__(self, name: str, preprocessor, backend):
        self.name = name
        self.preprocessor = preprocessor
        self.backend = backend


class ModelManager:
    def __init__(self):
        self._models: dict[str, ModelPipeline] = {}

    def add(self, pipeline: ModelPipeline) -> None:
        self._models[pipeline.name] = pipeline

    def get(self, name: Optional[str]) -> Optional[ModelPipeline]:
        if name in self._models:
            return self._models[name]
        if name is None and len(self._models) == 1:
            return next(iter(self._models.values()))
        return None

    def list_models(self) -> list[str]:
        return sorted(self._models)


class HttpError(Exception):
    """A request the connection cannot parse: answered with ``status`` and
    the connection closed."""

    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class Request:
    """One parsed HTTP request."""

    def __init__(self, method: str, target: str, version: str, headers: dict, body: bytes):
        self.method = method
        self.path = urlsplit(target).path
        self.version = version
        self.headers = headers  # lower-cased names
        self.body = body

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.1":
            return conn != "close"
        return False  # an HTTP/1.0 client gets one response a connection


class Response:
    """A complete (non-streamed) response."""

    def __init__(self, status: int, body: bytes, content_type: str, headers: Optional[dict] = None):
        self.status = status
        self.body = body
        self.content_type = content_type
        self.headers = headers or {}


def json_response(payload, status: int = 200, headers: Optional[dict] = None) -> Response:
    return Response(status, json.dumps(payload).encode(), "application/json; charset=utf-8", headers)


def text_response(text: str, status: int = 200) -> Response:
    return Response(status, text.encode(), "text/plain; charset=utf-8")


def _status_line(version: str, status: int) -> bytes:
    return f"{version} {status} {HTTPStatus(status).phrase}\r\n".encode()


class Connection:
    """One client connection: request parsing over a ``StreamReader`` with
    a push-back buffer (bytes read while watching for a disconnect belong to
    the next request), response writing, disconnect detection."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.pending = bytearray()
        self.eof = False

    async def _fill(self) -> bool:
        if self.eof:
            return False
        data = await self.reader.read(65536)
        if not data:
            self.eof = True
            return False
        self.pending += data
        return True

    async def _read_until_blank_line(self) -> Optional[bytes]:
        while True:
            idx = self.pending.find(b"\r\n\r\n")
            if idx != -1:
                head = bytes(self.pending[: idx + 4])
                del self.pending[: idx + 4]
                return head
            if len(self.pending) > MAX_HEADER_BYTES:
                raise HttpError(431, "request header fields too large")
            if not await self._fill():
                if self.pending.strip():
                    raise HttpError(400, "incomplete request head")
                return None

    async def _read_exactly(self, n: int) -> bytes:
        while len(self.pending) < n:
            if not await self._fill():
                raise HttpError(400, "incomplete request body")
        body = bytes(self.pending[:n])
        del self.pending[:n]
        return body

    async def read_request(self) -> Optional[Request]:
        """The next request, or None when the client closed between
        requests."""
        head = await self._read_until_blank_line()
        if head is None:
            return None
        lines = head.decode("latin-1").split("\r\n")
        try:
            method, target, version = lines[0].split(" ")
        except ValueError:
            raise HttpError(400, f"malformed request line {lines[0]!r}") from None
        if version not in ("HTTP/1.0", "HTTP/1.1"):
            raise HttpError(505, f"unsupported protocol version {version!r}")
        headers = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep or not name or name != name.strip():
                raise HttpError(400, f"malformed header line {line!r}")
            headers[name.lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            raise HttpError(501, "chunked request bodies are not supported; send Content-Length")
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            raise HttpError(400, "invalid Content-Length") from None
        if length < 0 or length > MAX_BODY_BYTES:
            raise HttpError(413, f"request body of {length} bytes refused")
        if length and headers.get("expect", "").lower() == "100-continue":
            self.writer.write(_status_line(version, 100) + b"\r\n")
        body = await self._read_exactly(length) if length else b""
        return Request(method, target, version, headers, body)

    async def send(self, request_version: str, resp: Response, keep_alive: bool) -> None:
        head = [
            _status_line(request_version, resp.status).decode(),
            f"Content-Type: {resp.content_type}\r\n",
            f"Content-Length: {len(resp.body)}\r\n",
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n",
        ]
        head += [f"{name}: {value}\r\n" for name, value in resp.headers.items()]
        self.writer.write("".join(head).encode() + b"\r\n" + resp.body)
        await self.writer.drain()

    async def wait_disconnect(self) -> None:
        """Returns when the client closes its end; bytes it sends meanwhile
        (a pipelined request) are kept for the next read."""
        while await self._fill():
            pass

    def close(self) -> None:
        self.writer.close()


class SseWriter:
    """``text/event-stream`` body: chunked transfer coding to an HTTP/1.1
    client, close-delimited to an HTTP/1.0 one."""

    def __init__(self, conn: Connection, version: str):
        self.conn = conn
        self.chunked = version == "HTTP/1.1"
        self.version = version

    async def prepare(self) -> None:
        head = _status_line(self.version, 200) + (
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
        )
        if self.chunked:
            head += b"Connection: keep-alive\r\nTransfer-Encoding: chunked\r\n"
        else:
            head += b"Connection: close\r\n"
        self.conn.writer.write(head + b"\r\n")
        await self.conn.writer.drain()

    async def write(self, data: bytes) -> None:
        if self.chunked:
            data = f"{len(data):x}\r\n".encode() + data + b"\r\n"
        self.conn.writer.write(data)
        await self.conn.writer.drain()

    async def write_eof(self) -> None:
        if self.chunked:
            self.conn.writer.write(b"0\r\n\r\n")
            await self.conn.writer.drain()


class HttpService:
    def __init__(self, manager: Optional[ModelManager] = None, host: str = "0.0.0.0", port: int = 8080,
                 qos: Optional[AdmissionController] = None):
        self.manager = manager or ModelManager()
        self.host = host
        self.port = port
        self.metrics = Metrics()
        # the QoS admission plane: budgets and class policy from the
        # DYNTPU_QOS_BUDGETS / DYNTPU_QOS_PRIORITIES env specs; with neither
        # set nothing throttles, but requests are still classified and counted
        self.qos = qos if qos is not None else AdmissionController(QosPolicy.from_env())
        self._server: Optional[asyncio.base_events.Server] = None
        self._connections: set[asyncio.Task] = set()
        self.routes = {
            ("POST", "/v1/chat/completions"): self._chat,
            ("POST", "/v1/completions"): self._completions,
            ("GET", "/v1/models"): self._models,
            ("GET", "/metrics"): self._metrics,
            ("GET", "/health"): self._health,
            # probe split: /live answers "is this process running" and must
            # never block on (or 503 because of) the model manager or any
            # downstream; /ready answers "should a load balancer send traffic
            # here"
            ("GET", "/live"): self._live,
            ("GET", "/ready"): self._ready,
        }

    # ---------------- lifecycle ----------------

    async def start(self) -> int:
        """Listen; returns the bound port (``port=0`` picks a free one)."""
        self._server = await asyncio.start_server(self._on_connection, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("http service listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for task in list(self._connections):
                task.cancel()
            await asyncio.gather(*self._connections, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None

    async def run_forever(self) -> None:
        await self.start()
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await self.stop()

    # ---------------- connections ----------------

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._connections.add(task)
        conn = Connection(reader, writer)
        try:
            while True:
                try:
                    request = await conn.read_request()
                except HttpError as e:
                    await conn.send("HTTP/1.1", text_response(f"{e.status}: {e}", e.status), keep_alive=False)
                    break
                if request is None:
                    break
                handler = self.routes.get((request.method, request.path))
                if handler is None:
                    known = any(path == request.path for _, path in self.routes)
                    status = 405 if known else 404
                    resp = text_response(f"{status}: {HTTPStatus(status).phrase}", status)
                else:
                    resp = await handler(request, conn)
                if resp is not None:  # else streamed: the handler wrote the response
                    await conn.send(request.version, resp, request.keep_alive)
                if not request.keep_alive or conn.eof:
                    break
        except ConnectionError:
            pass
        except Exception:
            log.exception("connection failed")
        finally:
            self._connections.discard(task)
            conn.close()

    # ---------------- handlers ----------------

    async def _health(self, request: Request, conn: Connection) -> Response:
        return json_response({"status": "ok", "models": self.manager.list_models()})

    async def _live(self, request: Request, conn: Connection) -> Response:
        # static by design: liveness never depends on the model manager
        return json_response({"status": "live"})

    async def _ready(self, request: Request, conn: Connection) -> Response:
        # the colocated engine is started before the service listens, and
        # the port's engine has no health plane yet that could say otherwise
        return json_response({"status": "ready", "models": self.manager.list_models()})

    async def _models(self, request: Request, conn: Connection) -> Response:
        return json_response(
            {
                "object": "list",
                "data": [
                    {"id": name, "object": "model", "owned_by": "dynamo-tpu"}
                    for name in self.manager.list_models()
                ],
            }
        )

    async def _metrics(self, request: Request, conn: Connection) -> Response:
        return text_response(self.metrics.render() + self.qos.render_metrics())

    def _error(self, status: int, message: str, code: str | None = None,
               headers: Optional[dict] = None) -> Response:
        err = {"message": message, "type": "invalid_request_error"}
        if code:
            err["code"] = code  # e.g. context_length_exceeded
        return json_response({"error": err}, status=status, headers=headers)

    async def _chat(self, request: Request, conn: Connection) -> Optional[Response]:
        return await self._handle(request, conn, kind="chat")

    async def _completions(self, request: Request, conn: Connection) -> Optional[Response]:
        return await self._handle(request, conn, kind="completion")

    async def _handle(self, request: Request, conn: Connection, kind: str) -> Optional[Response]:
        """A completion request: a Response, or None once a stream was
        written to ``conn``."""
        endpoint = "chat_completions" if kind == "chat" else "completions"
        t0 = time.monotonic()
        try:
            body = json.loads(request.body)
        except ValueError:
            self.metrics.inc_request("unknown", endpoint, "unary", "400")
            return self._error(400, "invalid JSON body")
        try:
            if not isinstance(body, dict):
                raise ProtocolError("request body must be a JSON object")
            req = (
                ChatCompletionRequest.from_dict(body)
                if kind == "chat"
                else CompletionRequest.from_dict(body)
            )
        except ProtocolError as e:
            model_name = str(body.get("model")) if isinstance(body, dict) else "unknown"
            self.metrics.inc_request(model_name, endpoint, "unary", "400")
            return self._error(400, str(e), code=e.code)

        pipeline = self.manager.get(req.model)
        if pipeline is None:
            # structured OpenAI 404 (error.code model_not_found) on BOTH
            # unary and stream paths: the model check runs before any SSE
            # response starts
            self.metrics.inc_request(str(req.model), endpoint, "unary", "404")
            return self._error(404, f"model {req.model!r} not found", code="model_not_found")

        model = pipeline.name
        rtype = "stream" if req.stream else "unary"

        # ---------- multi-tenant QoS admission (utils/qos.py) ----------
        # the x-priority header wins (strict: an unknown class is a 400,
        # not a silent downgrade), else the policy's tenant/adapter default
        tenant = request.headers.get("x-tenant", "")
        adapter = model.split(":", 1)[1] if ":" in model and "{" not in model else ""
        try:
            priority = parse_priority(request.headers.get("x-priority"))
        except ValueError as e:
            self.metrics.inc_request(model, endpoint, rtype, "400")
            return self._error(400, str(e), code="invalid_priority")
        if not request.headers.get("x-priority"):
            priority = self.qos.policy.priority_for(tenant, adapter)
        # engine backpressure: batch-class load sheds first, with a
        # retriable 429, while the estimated queue wait exceeds the budget
        if priority == "batch":
            bp_fn = getattr(pipeline.backend, "backpressure", None)
            bp = bp_fn() if bp_fn is not None else None
            budget = self.qos.policy.shed_wait_s
            if bp and bp.get("est_wait_s") is not None and bp["est_wait_s"] > budget:
                self.qos.record_shed(tenant, priority)
                self.metrics.inc_request(model, endpoint, rtype, "429")
                return self._error(
                    429,
                    f"engine overloaded (estimated wait {bp['est_wait_s']:.1f}s exceeds the "
                    f"{budget:.1f}s budget); batch-class load shed",
                    code="overloaded", headers={"Retry-After": str(bp.get("retry_after_s", 10))},
                )
        try:
            # off the event loop: chat-template render + encode are
            # CPU-bound; the dedicated small pool bounds thread-local
            # tokenizer loads to its worker count (llm/tokenizer.py
            # preprocessing_executor)
            from dynamo_tpu_torch.llm.tokenizer import preprocessing_executor

            loop = asyncio.get_running_loop()
            preprocess = (
                pipeline.preprocessor.preprocess_chat
                if kind == "chat"
                else pipeline.preprocessor.preprocess_completion
            )
            pre, annotations = await loop.run_in_executor(preprocessing_executor(), preprocess, req)
        except ProtocolError as e:
            # includes the preprocessor's context-length rejection: a
            # structured 400 with error.code "context_length_exceeded",
            # before any stream response starts
            self.metrics.inc_request(model, endpoint, rtype, "400")
            return self._error(400, str(e), code=e.code)

        # the tenant's token-rate budget pays prompt + output budget; an
        # exhausted one answers when the bucket will hold this request
        decision = self.qos.admit(tenant, priority, len(pre.token_ids) + max(0, pre.sampling.max_tokens),
                                  request_id=pre.request_id)
        if not decision.admitted:
            self.metrics.inc_request(model, endpoint, rtype, "429")
            return self._error(
                429, decision.reason + "; retry later", code="rate_limited",
                headers={"Retry-After": str(decision.retry_after_s)},
            )

        tool_matcher = None
        if kind == "chat" and req.tool_choice not in (None, "none") and not req.tools:
            self.metrics.inc_request(model, endpoint, rtype, "400")
            return self._error(400, "tool_choice requires a non-empty tools list")
        if kind == "chat" and req.tools and req.tool_choice != "none":
            try:
                tool_matcher = ToolCallingMatcher(req.tool_choice)
            except ValueError as e:
                self.metrics.inc_request(model, endpoint, rtype, "400")
                return self._error(400, str(e))
            if tool_matcher.forced_name is not None:
                known = {
                    (t.get("function") or {}).get("name")
                    for t in req.tools
                    if isinstance(t, dict)
                }
                if tool_matcher.forced_name not in known:
                    self.metrics.inc_request(model, endpoint, rtype, "400")
                    return self._error(
                        400, f"tool_choice function {tool_matcher.forced_name!r} is not in tools"
                    )

        # ambient request context: the request id stamped here; use_context
        # resets on exit so keep-alive connections cannot leak it
        meta = {"endpoint": endpoint, "model": model}
        if request.headers.get("x-request-id"):
            meta["x-request-id"] = request.headers["x-request-id"]
        ctx = new_context(request_id=pre.request_id, metadata=meta)
        ctx.ensure_trace_id()
        # the tags ride the preprocessed request: the scheduler serves it at
        # the admitted class
        pre.tenant = tenant
        pre.scenario = request.headers.get("x-scenario", "")
        pre.priority = priority

        self.metrics.inflight(model, 1)
        try:
            with use_context(ctx):
                # completions echo: the prompt text leads the output stream
                # (token-id prompts echo their detokenization)
                echo_text = None
                if kind == "completion" and req.echo:
                    if pre.logprobs is not None:
                        self.metrics.inc_request(model, endpoint, rtype, "400")
                        return self._error(400, "echo with logprobs is not supported")
                    if isinstance(req.prompt, str):
                        echo_text = req.prompt
                    else:
                        echo_text = pipeline.preprocessor.tokenizer.decode(
                            pre.token_ids, skip_special_tokens=pre.skip_special_tokens
                        )
                chunks = self._generate_chunks(pipeline, pre, kind, model, annotations, tool_matcher, echo_text)
                if req.stream:
                    await self._stream_response(request, conn, chunks, model, endpoint)
                    return None
                if kind == "chat":
                    result = await aggregate_chat_stream(chunks)
                else:
                    result = await aggregate_completion_stream(chunks)
            self.metrics.inc_request(model, endpoint, rtype, "200")
            return json_response(result)
        except ToolCallError as e:
            # model output did not satisfy a required/forced tool choice
            self.metrics.inc_request(model, endpoint, rtype, "422")
            return self._error(422, str(e))
        except ConnectionError:
            raise
        except Exception:
            log.exception("request failed")
            self.metrics.inc_request(model, endpoint, rtype, "500")
            return self._error(500, "internal error")
        finally:
            self.metrics.inflight(model, -1)
            self.metrics.observe_duration(model, endpoint, time.monotonic() - t0)

    async def _generate_chunks(
        self,
        pipeline: ModelPipeline,
        pre,
        kind: str,
        model: str,
        annotations: dict,
        tool_matcher: Optional[ToolCallingMatcher] = None,
        echo_text: Optional[str] = None,
    ) -> AsyncIterator[dict]:
        gen = ChatDeltaGenerator(model) if kind == "chat" else CompletionDeltaGenerator(model)
        usage = Usage(prompt_tokens=len(pre.token_ids))
        # requested annotations ride the SSE stream as named events, ahead of
        # the first delta (reference: protocols/annotated.rs envelope)
        for name, value in annotations.items():
            yield {"__event__": name, "data": value}
        if echo_text:
            yield gen.text_chunk(echo_text)
        want_timing = "timing" in pre.annotations
        t_start = time.monotonic()
        t_first = None
        t_prev = None  # last output-chunk arrival, for inter-token latency
        # With tools active the full text must be buffered so a tool-call JSON
        # response never leaks as content deltas (tool calls are matched on
        # complete messages, llm/tools.py).
        buffered: list[str] = []
        buffered_lp: list = []
        async for out in pipeline.backend.generate(pre):
            usage.completion_tokens = out.cumulative_tokens
            if t_first is None and out.token_ids:
                t_first = t_prev = time.monotonic()
                self.metrics.observe_ttft(model, t_first - t_start)
                # OpenAI semantics: the role delta leads the stream at first-
                # token time, the client's honest TTFT signal
                role = getattr(gen, "role_chunk", None)
                if role is not None and not gen._sent_role:
                    yield role()
            elif t_prev is not None and out.token_ids:
                # engine windows arrive as multi-token chunks: the honest
                # per-token number is the chunk gap amortized over its tokens
                now = time.monotonic()
                self.metrics.observe_itl(model, (now - t_prev) / len(out.token_ids))
                t_prev = now
            if tool_matcher is not None:
                if out.text:
                    buffered.append(out.text)
                if out.logprobs:
                    buffered_lp.extend(out.logprobs)
            elif out.text or out.logprobs:
                yield gen.text_chunk(out.text, logprobs=out.logprobs)
            if out.finished:
                finish = out.finish_reason or "stop"
                if tool_matcher is not None:
                    text = "".join(buffered)
                    calls = tool_matcher.get_calls(text)
                    if calls:
                        yield gen.tool_calls_chunk(calls)
                        finish = "tool_calls"
                    elif text:
                        yield gen.text_chunk(text, logprobs=buffered_lp or None)
                if want_timing:
                    total = time.monotonic() - t_start
                    ttft = (t_first - t_start) if t_first is not None else None
                    decode_s = (time.monotonic() - t_first) if t_first is not None else 0.0
                    yield {
                        "__event__": "timing",
                        "data": {
                            "ttft_ms": round(ttft * 1e3, 1) if ttft is not None else None,
                            "total_ms": round(total * 1e3, 1),
                            "output_tokens": usage.completion_tokens,
                            "cached_tokens": out.cached_tokens,
                            "decode_tok_per_s": (
                                round((usage.completion_tokens - 1) / decode_s, 1)
                                if usage.completion_tokens > 1 and decode_s > 0
                                else None
                            ),
                        },
                    }
                yield gen.finish_chunk(finish, usage)
                return

    async def _stream_response(
        self, request: Request, conn: Connection, chunks: AsyncIterator[dict], model: str, endpoint: str
    ) -> None:
        """Write ``chunks`` as SSE. A client that closes its end cancels the
        pump, and with it the engine request (the engine's stream frees its
        slot and pages when its generator closes)."""
        out = SseWriter(conn, request.version)
        await out.prepare()
        status = "200"

        async def pump() -> None:
            nonlocal status
            try:
                async for chunk in chunks:
                    if "__event__" in chunk:
                        await out.write(sse.encode_event(chunk["__event__"], chunk.get("data")))
                        continue
                    await out.write(sse.encode_data(chunk))
                await out.write(sse.encode_done())
            except ToolCallError as e:
                status = "422"
                err = json.dumps({"error": {"message": str(e), "type": "tool_call_error"}})
                await out.write(f"data: {err}\n\ndata: [DONE]\n\n".encode())
            except ConnectionError:
                raise
            except Exception:
                log.exception("stream failed")
                status = "500"
                await out.write(b'data: {"error": {"message": "internal error"}}\n\ndata: [DONE]\n\n')
            await out.write_eof()

        pumping = asyncio.ensure_future(pump())
        gone = asyncio.ensure_future(conn.wait_disconnect())
        try:
            await asyncio.wait({pumping, gone}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            for task in (pumping, gone):
                task.cancel()  # a no-op on the one that finished
            pumped, _ = await asyncio.gather(pumping, gone, return_exceptions=True)
            await chunks.aclose()
            if pumping.cancelled() or isinstance(pumped, ConnectionError):
                status = "499"  # the client went away first
                conn.eof = True  # nothing more is read from this connection
            elif isinstance(pumped, Exception):
                log.error("stream failed: %r", pumped)
                status = "500"
            self.metrics.inc_request(model, endpoint, "stream", status)
