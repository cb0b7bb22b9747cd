"""``dynamo-tpu-torch run``: the port's universal CLI (analogue of the
reference's dynamo-run, reference: launch/dynamo-run/src/lib.rs:75-433).

    python -m dynamo_tpu_torch.launch.run run MODEL --in http --out torch [--device cuda]

in={http,text,batch:<file.jsonl>,dyn://ns.comp.ep} x out={echo,torch,dyn://ns.comp.ep}.

Port of ``dynamo_tpu/launch/run.py``: the same parser, ``--out torch`` for
the reference's ``--out jax``, and ``--device {cuda,cpu}`` (default ``cuda``),
the port's counterpart of the reference's ``JAX_PLATFORMS``; on ``cuda``
without a card the engine raises, it never falls back to the CPU. The
reference's options and subcommands that the port does not run yet
(``serve``, ``build``, ``deploy``, ``pytok:``, tp/pp, SLO targets)
raise ``NotPorted``; LoRA adapters (``--lora-adapters a1,a2=<dir>,a3=random:7``)
serve as model names ``<base>:<adapter>``; ``--in dyn://`` serves the engine as a worker endpoint
and ``--out dyn://`` drives a remote one (the control plane is
``$DYNTPU_CPLANE``); ``--speculative ngram:<k>`` and
``draft:<model>:<k>`` run. MODEL is a
tiny family (``tiny[:{json}]``, ``tiny-mla[:{json}]``) or a local HF
checkpoint directory (Llama / Qwen2 / DeepSeek; its ``tokenizer.json``
where present, else the byte tokenizer); ``--quantize int8_wo`` serves its
weights as int8.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="dynamo-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)
    run = sub.add_parser("run", help="run a serving pipeline")
    run.add_argument("model", nargs="?", help="model path or registry name")
    run.add_argument("--in", dest="input", default="text", help="http|text|batch:<file.jsonl>|dyn://ns.comp.ep")
    run.add_argument("--out", dest="output", default="echo", help="echo|torch|dyn://ns.comp.ep")
    run.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                     help="where --out torch runs (cuda raises without a card)")
    run.add_argument("--http-port", type=int, default=8080, help="0 picks a free port")
    run.add_argument("--max-model-len", type=int, default=None)
    run.add_argument("--num-pages", type=int, default=None, help="KV cache pages")
    run.add_argument("--max-seqs", type=int, default=None, help="decode batch slots")
    run.add_argument("--tp", type=int, default=None, help="tensor-parallel degree (not ported)")
    run.add_argument("--pp", type=int, default=None, help="pipeline-parallel stages (not ported)")
    run.add_argument("--quantize", choices=["int8_wo"], default=None,
                     help="weight-only int8 quantization at load time")
    run.add_argument(
        "--kv-cache-dtype", choices=["bf16", "int8"], default=None,
        help="KV cache storage dtype: int8 stores pages as int8 + per-row "
             "scales — half the attention bytes, ~2x page capacity",
    )
    run.add_argument(
        "--speculative", default=None, metavar="KIND:...",
        help="speculative decoding: ngram:<k> proposes from the sequence's own history (prompt-lookup); "
             "draft:<model>:<k> loads a second registry model that drafts k tokens a round in one batched "
             "step (with --quantize / --kv-cache-dtype); both verify in one batched forward pass",
    )
    run.add_argument("--lora-adapters", default=None, metavar="SPECS",
                     help="comma-separated LoRA adapter specs served as <model>:<name> (name, name=<dir>, "
                          "name=random:<seed>); a mixed-adapter batch decodes in one pass")
    run.add_argument("--max-loras", type=int, default=None,
                     help="device adapter slots (default 4); more adapters than slots evict LRU")
    run.add_argument("--lora-rank", type=int, default=None,
                     help="adapter pool rank (default 8); smaller adapters zero-pad, larger raise")
    run.add_argument("--max-tokens", type=int, default=None, help="batch mode default max_tokens")
    run.add_argument("--slo-ttft-ms", type=float, default=None, help="TTFT SLO target in ms (not ported)")
    run.add_argument("--slo-itl-ms", type=float, default=None, help="ITL SLO target in ms (not ported)")
    for name in ("serve", "build", "deploy"):
        sub.add_parser(name, help=f"the reference's {name} (not ported)", add_help=False)
    return p


def main(argv: list[str] | None = None) -> int:
    from dynamo_tpu_torch.launch._run_impl import NotPorted

    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("serve", "build", "deploy"):
        raise NotPorted(f"the {argv[0]!r} subcommand")
    args = build_parser().parse_args(argv)
    if args.command == "run":
        from dynamo_tpu_torch.launch._run_impl import run_command

        return run_command(args)
    return 1


if __name__ == "__main__":
    sys.exit(main())
