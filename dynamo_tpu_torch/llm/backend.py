"""Detokenizing backend: engine token stream -> text deltas with stop-condition
jailing and finish reasons.

Mirrors the reference Backend (reference: lib/llm/src/backend.rs:66-508):
wraps a tokens-in/tokens-out engine, performs incremental detokenization via a
DecodeStream, holds back ("jails") text that could be the start of a stop
sequence, and truncates at the stop match.

Port of ``dynamo_tpu/llm/backend.py`` over ``AsyncTorchEngine.generate_batched``.
``backpressure`` feeds the HTTP service's QoS shed. Left out with the
engine's health plane (not ported): ``availability``, the probe behind the
reference service's draining 503.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

from dynamo_tpu_torch.engine.scheduler import EngineRequest
from dynamo_tpu_torch.llm.protocols.common import BackendOutput, PreprocessedRequest
from dynamo_tpu_torch.llm.tokenizer import DecodeStream, Tokenizer


class _StopJail:
    """Holds back text while it could still be completing a stop string."""

    def __init__(self, stops: tuple[str, ...]):
        self.stops = [s for s in stops if s]
        self.pending = ""

    def push(self, text: str) -> tuple[str, bool]:
        """Returns (emit_now, stopped)."""
        if not self.stops:
            return text, False
        self.pending += text
        # full stop match: emit everything before it and signal stop
        best = None
        for s in self.stops:
            idx = self.pending.find(s)
            if idx != -1 and (best is None or idx < best[0]):
                best = (idx, s)
        if best is not None:
            return self.pending[: best[0]], True
        # hold back the longest tail that is a proper prefix of any stop string
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.pending)), 0, -1):
                if self.pending.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        emit = self.pending[: len(self.pending) - hold] if hold else self.pending
        self.pending = self.pending[len(emit) :]
        return emit, False

    def flush(self) -> str:
        out, self.pending = self.pending, ""
        return out


class Backend:
    """ExecutionContext wrapper: PreprocessedRequest -> BackendOutput stream."""

    def __init__(self, engine, tokenizer: Tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer

    def backpressure(self) -> Optional[dict]:
        """Engine queue pressure for the HTTP service's QoS shed check:
        queue depth x measured drain rate -> estimated wait for a NEW
        request (utils/qos.py). None when the engine has no backpressure
        surface."""
        bp_fn = getattr(self.engine, "backpressure_snapshot", None)
        if bp_fn is None:
            return None
        try:
            return bp_fn()
        except Exception:
            return None

    def _token_repr(self, token_id: int) -> tuple[str, list[int]]:
        text = self.tokenizer.decode([token_id], skip_special_tokens=False)
        return text, list(text.encode("utf-8"))

    def _logprob_entry(self, step) -> dict:
        """StepOutput logprobs -> OpenAI-shaped entry (token strings decoded
        here, next to the tokenizer)."""
        tok_str, tok_bytes = self._token_repr(step.token)
        entry = {"token": tok_str, "logprob": step.logprob, "bytes": tok_bytes}
        if step.top_logprobs is not None:
            top = []
            for tid, lp in step.top_logprobs:
                t_str, t_bytes = self._token_repr(tid)
                top.append({"token": t_str, "logprob": lp, "bytes": t_bytes})
            entry["top"] = top
        return entry

    async def generate(self, request: PreprocessedRequest) -> AsyncIterator[BackendOutput]:
        eos_ids = tuple(request.eos_token_ids) or tuple(self.tokenizer.eos_token_ids)
        engine_req = EngineRequest(
            request_id=request.request_id,
            token_ids=list(request.token_ids),
            sampling=request.sampling,
            eos_token_ids=eos_ids,
            images=list(request.images),
            logprobs=request.logprobs,
            kv_holder_addr=getattr(request, "kv_holder_addr", ""),
            kv_holder_blocks=getattr(request, "kv_holder_blocks", 0),
            lora_name=getattr(request, "lora_name", ""),
            tenant=getattr(request, "tenant", ""),
            scenario=getattr(request, "scenario", ""),
            priority=getattr(request, "priority", ""),
        )
        decoder = DecodeStream(
            self.tokenizer,
            prompt_ids=request.token_ids,
            skip_special_tokens=getattr(request, "skip_special_tokens", True),
        )
        jail = _StopJail(request.stop_strings)
        count = 0
        cached = 0
        # engine windows arrive as StepOutput batches (decode_steps tokens per
        # thread crossing — and a speculative engine emits whole accepted
        # chunks); one detok + one BackendOutput per batch collapses the
        # per-token overhead that halved HTTP-level throughput. Engines
        # without a batched API (echo, remote proxies) stream singletons.
        # Stop strings still ride the batched stream, but scan per token
        # WITHIN each chunk (see below): a stop can complete on any token of
        # a multi-token window, and token_ids/usage/logprobs must end AT the
        # matching token, not at the window boundary.
        if hasattr(self.engine, "generate_batched"):
            stream = self.engine.generate_batched(engine_req)
        else:
            async def _singletons():
                async for s in self.engine.generate(engine_req):
                    yield [s]

            stream = _singletons()
        if jail.stops:
            async for out in self._generate_with_stops(
                request, stream, decoder, jail, eos_ids
            ):
                yield out
            return
        async for steps in stream:
            ids: list[int] = []
            detok_ids: list[int] = []
            lp_entries = None
            finished = False
            finish_reason = None
            for step in steps:
                if step.token is not None:
                    count += 1
                    ids.append(step.token)
                    # suppress eos token text
                    if not (step.finish_reason == "stop" and step.token in eos_ids):
                        detok_ids.append(step.token)
                    if step.logprob is not None:
                        if lp_entries is None:
                            lp_entries = []
                        lp_entries.append(self._logprob_entry(step))
                cached = max(cached, step.cached_tokens)
                if step.finished:
                    finished = True
                    finish_reason = step.finish_reason
                    break
            text = (decoder.step_many(detok_ids) or "") if detok_ids else ""

            emit, stopped = jail.push(text) if text else ("", False)
            if stopped:
                yield BackendOutput(
                    request_id=request.request_id,
                    text=emit,
                    token_ids=ids,
                    finish_reason="stop",
                    cumulative_tokens=count,
                    cached_tokens=cached,
                    logprobs=lp_entries,
                )
                return
            if finished:
                # flush only if no stop strings were configured mid-jail; a
                # partial stop prefix at end-of-stream is emitted (it never
                # completed the stop sequence)
                emit += jail.flush()
                yield BackendOutput(
                    request_id=request.request_id,
                    text=emit,
                    token_ids=ids,
                    finish_reason=finish_reason,
                    cumulative_tokens=count,
                    cached_tokens=cached,
                    logprobs=lp_entries,
                )
                return
            if emit or ids:
                yield BackendOutput(
                    request_id=request.request_id,
                    text=emit,
                    token_ids=ids,
                    cumulative_tokens=count,
                    cached_tokens=cached,
                    logprobs=lp_entries,
                )

    async def _generate_with_stops(
        self, request, stream, decoder: DecodeStream, jail: _StopJail, eos_ids
    ) -> AsyncIterator[BackendOutput]:
        """Stop-string stream: one BackendOutput per engine window, but detok
        + jail scanning walk token by token WITHIN each multi-token chunk, so
        a stop sequence completing mid-chunk truncates text, token_ids, and
        usage at exactly the matching token (never just the newest one)."""
        count = 0
        cached = 0
        async for steps in stream:
            ids: list[int] = []
            parts: list[str] = []
            lp_entries = None
            finished = False
            finish_reason = None
            stopped = False
            for step in steps:
                if step.token is not None:
                    count += 1
                    ids.append(step.token)
                    if step.logprob is not None:
                        if lp_entries is None:
                            lp_entries = []
                        lp_entries.append(self._logprob_entry(step))
                    # suppress eos token text
                    if step.finish_reason == "stop" and step.token in eos_ids:
                        piece = None
                    else:
                        piece = decoder.step(step.token)
                    if piece:
                        emit, stopped = jail.push(piece)
                        if emit:
                            parts.append(emit)
                        if stopped:
                            break
                cached = max(cached, step.cached_tokens)
                if step.finished:
                    finished = True
                    finish_reason = step.finish_reason
                    break
            if stopped or finished:
                if finished and not stopped:
                    # a partial stop prefix at end-of-stream never completed
                    # the stop sequence: emit it
                    parts.append(jail.flush())
                yield BackendOutput(
                    request_id=request.request_id,
                    text="".join(parts),
                    token_ids=ids,
                    finish_reason="stop" if stopped else finish_reason,
                    cumulative_tokens=count,
                    cached_tokens=cached,
                    logprobs=lp_entries,
                )
                return
            if parts or ids:
                yield BackendOutput(
                    request_id=request.request_id,
                    text="".join(parts),
                    token_ids=ids,
                    cumulative_tokens=count,
                    cached_tokens=cached,
                    logprobs=lp_entries,
                )
