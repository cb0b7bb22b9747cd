"""The HTTP edge's share of the serve workload's wall on the card: the same
engine driven in process and over HTTP, in turns.

    python -m dynamo_tpu_torch.tools.profile_http [--rounds 2] [--out profile_http.json]

One engine built as ``run`` builds it for ``run 'tiny:{Llama-3-8B}' --in
http --out torch --max-model-len 2112 --num-pages N --max-seqs 16`` (the
tiny card's engine defaults, as in ``chip_smoke.py``'s http serve phase:
page size 4, prefill buckets 16 / 32), its HTTP service on a background
event loop, and the 16-request serve workload (``tools/workload.py``,
greedy, 64 tokens each) driven ``rounds`` times in each of three ways, in
turns (direct, http-proc, http-threads, then the reverse order), after the
kernels' build and a warm-up run in process that is not kept:

  - ``direct``: ``engine.generate`` in process, every request submitted at
    once;
  - ``http-proc``: streamed ``/v1/completions`` from 16 client threads in
    another process (this module's ``--client`` mode), as remote clients
    would send them;
  - ``http-threads``: the same clients in threads of this process, as
    ``chip_smoke.py`` runs them (they share the interpreter with the
    engine's host loop).

Each run reports its wall at the caller (``wall_s``; the client process's
start-up included for http-proc) and at the engine (``engine_wall_s``, the
first request's arrival to the last one's end), output tok/s over the
latter, TTFT p50 and max (the first arrival to each request's first token
out of the engine), the packed prefill calls
(``runner.prefill_chunk_batch``), the spread of the requests' arrival at
the engine and, where the engine records it, the run's own step anatomy
(``anatomy``: host fraction, prefill fixed ms, roofline fractions,
dispatches). The engine's background warmup (where the tree has one) ends
before the first run, and each run starts from a cold prefix cache (where
the tree has one): the runs repeat the same prompts. Needs a card; prints one JSON line with the card's
name and power limit, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
MODES = ("direct", "http-proc", "http-threads")


def http_call(port: int, method: str, path: str, body=None) -> tuple[int, bytes]:
    """(status, body) of one request to the service on ``port``."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_stream(port: int, body: dict) -> tuple[list, float]:
    """One streamed completion: (its SSE messages, the client's seconds from
    sending to the end of the stream). Raises unless it is answered 200
    with an event stream."""
    import http.client

    from dynamo_tpu_torch.llm.protocols.sse import SseDecoder

    t0 = time.monotonic()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/completions", body=json.dumps(body), headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or not resp.getheader("Content-Type", "").startswith("text/event-stream"):
            raise RuntimeError(f"stream answered {resp.status}: {resp.read()[:300]!r}")
        decoder, msgs = SseDecoder(), []
        while chunk := resp.read1(65536):
            msgs.extend(decoder.feed(chunk))
        return msgs, time.monotonic() - t0
    finally:
        conn.close()


def stream_all(port: int, bodies: list[dict]) -> list[int]:
    """``bodies`` as concurrent streams, one client thread each; the
    completion tokens of each (from its finish chunk)."""
    with ThreadPoolExecutor(len(bodies)) as pool:
        results = list(pool.map(lambda b: http_stream(port, b), bodies))
    return [msgs[-2].json()["usage"]["completion_tokens"] for msgs, _ in results]


def instrument(engine) -> dict:
    """Stamp each request's arrival at ``engine``, its first token out and
    its end, and count packed prefill calls; returns the live record."""
    rec = {"requests": [], "prefill_calls": 0}
    inner_generate, inner_prefill = engine.generate_batched, engine.runner.prefill_chunk_batch

    async def generate_batched(request):
        entry = {"arrive": time.monotonic(), "first": None, "done": None}
        rec["requests"].append(entry)
        async for batch in inner_generate(request):
            now = time.monotonic()
            if entry["first"] is None and any(o.token is not None for o in batch):
                entry["first"] = now
            if any(o.finished for o in batch):
                entry["done"] = now
            yield batch

    def prefill_chunk_batch(*args, **kwargs):
        rec["prefill_calls"] += 1
        return inner_prefill(*args, **kwargs)

    engine.generate_batched = generate_batched
    engine.runner.prefill_chunk_batch = prefill_chunk_batch
    return rec


def completion_bodies(requests) -> list[dict]:
    """The workload's requests as streamed completions with token-id
    prompts, greedy, ignoring EOS as the engine requests do."""
    return [{"prompt": r.token_ids, "stream": True, "temperature": 0, "max_tokens": r.sampling.max_tokens,
             "ext": {"ignore_eos": True}} for r in requests]


def run_once(mode: str, engine, on_loop, port: int, requests, rec: dict) -> dict:
    """One run of ``requests`` in ``mode``; every request must end with its
    max_tokens."""
    want = [r.sampling.max_tokens for r in requests]
    reset = getattr(engine.allocator, "reset_prefix_cache", None)
    if reset is not None:  # every run prefills its prompts: the prefix cache starts cold
        on_loop(engine.run_on_engine(reset))
    rec["requests"].clear()
    rec["prefill_calls"] = 0
    anatomy = getattr(engine.scheduler, "anatomy", None)
    if anatomy is not None:  # this run's own (the engine is idle between runs)
        anatomy = engine.scheduler.anatomy = type(anatomy)(roofline=anatomy.roofline)
    t0 = time.monotonic()
    if mode == "direct":
        async def direct():
            async def one(req):
                n = 0
                async for out in engine.generate(req):
                    n += out.token is not None
                return n

            return await asyncio.gather(*(one(r) for r in requests))

        got = on_loop(direct())
    elif mode == "http-threads":
        got = stream_all(port, completion_bodies(requests))
    else:
        proc = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.tools.profile_http", "--client", str(port)],
                              input=json.dumps(completion_bodies(requests)), capture_output=True, text=True,
                              cwd=ROOT, timeout=900, check=True)
        got = json.loads(proc.stdout.strip().splitlines()[-1])
    wall = time.monotonic() - t0
    if list(got) != want:
        raise RuntimeError(f"{mode}: completion tokens {got}, want {want}")
    start = min(e["arrive"] for e in rec["requests"])
    firsts = [e["first"] - start for e in rec["requests"]]
    engine_wall = max(e["done"] for e in rec["requests"]) - start
    extra = {}
    if anatomy is not None:
        from dynamo_tpu_torch.tools.profile_serve import anatomy_summary

        extra["anatomy"] = anatomy_summary(anatomy)
    return {
        "mode": mode, "wall_s": wall, "engine_wall_s": engine_wall, "output_tok_s": sum(want) / engine_wall,
        "ttft_p50_ms": float(np.median(firsts)) * 1e3, "ttft_max_ms": max(firsts) * 1e3,
        "prefill_calls": rec["prefill_calls"],
        "arrival_spread_ms": (max(e["arrive"] for e in rec["requests"]) - start) * 1e3,
        **extra,
    }


def run_modes(engine, port: int, on_loop, requests, rounds: int) -> dict:
    """A warm-up run in process (not kept: a fresh engine's first calls pay
    its lazy set-up), then ``rounds`` runs of each mode, in turns (forward,
    then reversed, ...), each with fresh request ids; returns {"runs":
    [...], "median": {mode: {metric: median}}}. The engine's background
    warmup, where it has one, ends first (its calls are no run's)."""
    if hasattr(engine, "wait_warmup"):
        on_loop(engine.wait_warmup())
    rec = instrument(engine)
    warm = requests()
    for req in warm:
        req.request_id = f"warm-{req.request_id}"
    run_once("direct", engine, on_loop, port, warm, rec)
    runs = []
    for r in range(rounds):
        for mode in MODES if r % 2 == 0 else MODES[::-1]:
            reqs = requests()
            for req in reqs:
                req.request_id = f"{mode}-{r}-{req.request_id}"
            runs.append(run_once(mode, engine, on_loop, port, reqs, rec))
            print(json.dumps(runs[-1]), flush=True)
    median = {
        mode: {k: float(np.median([x[k] for x in runs if x["mode"] == mode])) for k in runs[0]
               if k not in ("mode", "anatomy")}
        for mode in MODES
    }
    return {"runs": runs, "median": median}


def client_main(port: int) -> None:
    """``--client PORT``: stream the JSON list of bodies on stdin, print the
    completion tokens of each as one JSON line."""
    print(json.dumps(stream_all(port, json.loads(sys.stdin.read()))), flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--client", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.client is not None:
        client_main(args.client)
        return {}

    import torch

    from dynamo_tpu_torch.frontends.http import build_service
    from dynamo_tpu_torch.launch import run
    from dynamo_tpu_torch.launch._run_impl import _build_engine
    from dynamo_tpu_torch.ops.kernels import _build
    from dynamo_tpu_torch.tools.timing import card
    from dynamo_tpu_torch.tools.workload import LLAMA3_8B, MAX_TOKENS, serve_requests

    if not torch.cuda.is_available():
        raise SystemExit("profile_http needs a CUDA device")
    _build.build(["paged_attention", "prefill_attention"])  # K1 and K2, before any timing
    page_size, max_model_len = 4, 2112  # the tiny card's block size; the workload's longest prompt + 64
    pages = sum(-(-(len(r.token_ids) + MAX_TOKENS) // page_size) for r in serve_requests())
    run_args = run.build_parser().parse_args([
        "run", "tiny:" + json.dumps(LLAMA3_8B), "--in", "http", "--out", "torch", "--http-port", "0",
        "--max-model-len", str(max_model_len), "--num-pages", str(int(pages / 0.9) + 2), "--max-seqs", "16"])
    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, name="profile-http", daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(900)

    async def boot():
        engine = await _build_engine(run_args)
        service = build_service(engine, run_args, host="127.0.0.1")
        return engine, service, await service.start()

    engine = service = None
    try:
        engine, service, port = on_loop(boot())
        if engine.config.page_size != page_size:
            raise RuntimeError(f"engine page size {engine.config.page_size}, want {page_size}")
        result = run_modes(engine, port, on_loop, serve_requests, args.rounds)
    finally:
        if service is not None:
            on_loop(service.stop())
        if engine is not None:
            on_loop(engine.shutdown())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
        loop.close()
    result = {"device": card(), "workload": "tools/workload.py serve_requests over run --in http, page size 4",
              **result}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return result


if __name__ == "__main__":
    main()
