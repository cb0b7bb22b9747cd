"""What a decode step costs on the card: the port of ``tools/profile_decode.py``
on the reference bench's headline engine (``tools/workload.py
bench_config``: the ~1.3B Llama shape, B 64, page size 128, bf16, seeded
random weights), each part timed as a CUDA graph replay and as the eager
body, under one timer.

    python -m dynamo_tpu_torch.tools.profile_decode [batch] [page_size] [--out F]

Per-step cost = (t(window of 64 steps) - t(window of 8 steps)) / 56: a
call's fixed cost cancels in the difference. Each t is the best of 4 walls
of one call whose tokens are read back to the host, after a call that
captures its graph (and warms the eager path). Every sequence decodes at
position 192 (bench.py's 128-token prompt plus half its 128 output tokens),
in its own pages. Reported per decode step:

  window                 ``ModelRunner.dispatch_decode_window`` (the model,
                         sampling and the token feedback), greedy
  model_only             ``model.decode`` alone, argmax feedback
  sampling_and_feedback  window - model_only

each under ``graph`` (the runner's graph replays; the model alone captured
in the runner's graph cache) and ``eager`` (the same bodies run
op by op), against the decode floor: the weights and the live KV pages
read once a step (``utils/step_anatomy.py roofline_for_runner``, the H100
SXM's 3.35e12 B/s). Prints one JSON line with the card's name and power
limit. On the CPU (tests) only ``eager`` runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch

STEPS = (8, 64)  # the two window lengths differenced


def best_wall(fn, reps: int = 4) -> float:
    """The best of ``reps`` walls of ``fn()`` after one call that is not
    timed (a capture, or the eager path's first use)."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


@contextlib.contextmanager
def eager_bodies(runner):
    """The runner's step bodies run op by op inside (its graphs kept)."""
    graphs, runner.graphs = runner.graphs, None
    try:
        yield
    finally:
        runner.graphs = graphs


def decode_state(cfg, B: int, ctx: int) -> dict:
    """Every slot active at position ``ctx`` in its own pages, with room
    for the longest window's writes (the reference's layout)."""
    ps = cfg.page_size
    npp = -(-ctx // ps) + 1
    if 1 + B * npp > cfg.num_pages:
        raise SystemExit(f"pool too small: need {1 + B * npp} pages, have {cfg.num_pages}")
    pt = np.zeros((B, cfg.max_pages_per_seq), np.int32)
    for i in range(B):
        pt[i, :npp] = 1 + i * npp + np.arange(npp)
    return dict(
        positions=np.full(B, ctx, np.int32), page_tables=pt, active=np.ones(B, bool),
        limits=np.full(B, npp * ps - 2, np.int32), temps=np.zeros(B, np.float32),
        top_ks=np.zeros(B, np.int32), top_ps=np.ones(B, np.float32), live_pages=B * -(-ctx // ps),
    )


def measure(runner, cfg, B: int, ctx: int, steps=STEPS, reps: int = 4) -> dict:
    """{mode: {"window": (t short, t long), "model_only": (...)}} walls in
    seconds; mode "graph" only when the runner has graphs (the card)."""
    st = decode_state(cfg, B, ctx)
    model, dev = runner.model, runner.device
    pt = torch.from_numpy(st["page_tables"]).to(dev)
    act = torch.from_numpy(st["active"]).to(dev)

    def window(n):
        return runner.dispatch_decode_window(st["positions"], st["page_tables"], st["active"], st["limits"],
                                             st["temps"], st["top_ks"], st["top_ps"], n).numpy()

    def model_body(n, tokens, positions):
        out = torch.empty((n, B), dtype=torch.int32, device=dev)
        for i in range(n):
            logits, _ = model.decode(runner.kv_cache, tokens, positions, pt, act)
            tokens = logits.argmax(-1).to(torch.int32)
            positions = positions + 1
            out[i] = tokens
        return (out,)

    def model_only(n, graphed):
        positions = torch.from_numpy(st["positions"]).to(dev)
        tokens = torch.zeros(B, dtype=torch.int32, device=dev)
        if not graphed:
            return model_body(n, tokens, positions)[0].cpu()
        out = runner.graphs.run(
            "model_only", ("model_only", n), lambda: (torch.empty_like(tokens), torch.empty_like(positions)),
            lambda inputs: (inputs[0].copy_(tokens), inputs[1].copy_(positions)),
            lambda t, p: model_body(n, t, p),
        )
        return out[0].cpu()

    modes = (["graph"] if runner.graphs is not None else []) + ["eager"]
    times = {}
    with torch.no_grad():
        for mode in modes:
            ctx_mgr = eager_bodies(runner) if mode == "eager" else contextlib.nullcontext()
            with ctx_mgr:
                times[mode] = {
                    "window": tuple(best_wall(lambda n=n: window(n), reps) for n in steps),
                    "model_only": tuple(best_wall(lambda n=n: model_only(n, mode == "graph"), reps) for n in steps),
                }
    return times


def summarize(times: dict, roof, live_pages: int, B: int, steps=STEPS) -> dict:
    """Per-step ms of each part and mode by differencing, tokens/s of the
    window, and the floor: the weights and ``live_pages`` KV pages read
    once a step."""
    span = steps[1] - steps[0]
    floor_s = roof.step_floor_seconds(live_pages)
    out = {"per_step_ms": {}, "window_tok_s": {}, "pct_of_roofline": {}}
    for mode, t in times.items():
        window = (t["window"][1] - t["window"][0]) / span
        model = (t["model_only"][1] - t["model_only"][0]) / span
        out["per_step_ms"][mode] = {"window": window * 1e3, "model_only": model * 1e3,
                                    "sampling_and_feedback": (window - model) * 1e3}
        out["window_tok_s"][mode] = B / window
        out["pct_of_roofline"][mode] = 100 * floor_s / window
    out.update(hbm_floor_ms=floor_s * 1e3, param_bytes=roof.param_bytes,
               kv_bytes_per_step=live_pages * roof.page_bytes, hbm_bw_bytes_s=roof.hbm_bw)
    return out


def main(argv=None) -> dict:
    from dynamo_tpu_torch.engine.model_runner import ModelRunner
    from dynamo_tpu_torch.models.registry import load_model
    from dynamo_tpu_torch.tools.timing import card
    from dynamo_tpu_torch.tools.workload import BENCH_DECODE_TOKENS, BENCH_PROMPT_LEN, HEADLINE, bench_config
    from dynamo_tpu_torch.utils.step_anatomy import roofline_for_runner

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=HEADLINE[0])
    ap.add_argument("page_size", nargs="?", type=int, default=HEADLINE[1])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    torch.cuda.set_device(0)
    smi = card()
    cfg = bench_config(args.batch, args.page_size)
    runner = ModelRunner(cfg, load_model(cfg.model_id, device="cuda"))
    ctx = BENCH_PROMPT_LEN + BENCH_DECODE_TOKENS // 2
    times = measure(runner, cfg, args.batch, ctx)
    out = {"device": smi, "B": args.batch, "page_size": args.page_size, "ctx": ctx,
           "model": "bench 1.3B (tools/workload.py BENCH_1_3B)", "steps": list(STEPS),
           **summarize(times, roofline_for_runner(runner, cfg), decode_state(cfg, args.batch, ctx)["live_pages"],
                       args.batch),
           "walls_s": times, "captures": runner.compile_monitor.snapshot()}
    for mode, parts in out["per_step_ms"].items():
        print(f"profile_decode [{smi}] {mode}: window {parts['window']:.3f} ms/step, model alone "
              f"{parts['model_only']:.3f}, sampling + feedback {parts['sampling_and_feedback']:.3f}; "
              f"{out['window_tok_s'][mode]:.1f} tok/s, floor {out['hbm_floor_ms']:.3f} ms "
              f"({out['pct_of_roofline'][mode]:.1f}% of the window)", flush=True)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()
