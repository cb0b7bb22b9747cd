"""Engine configuration (port of ``dynamo_tpu/engine/config.py``): the fields
the port reads, plus ``device``. The reference's ``pp`` gate on LoRA has no
counterpart: the port runs no pipeline parallelism."""

from __future__ import annotations

from dataclasses import dataclass

from dynamo_tpu_torch.quant.int8 import QUANT_MODES
from dynamo_tpu_torch.quant.kv import KV_CACHE_DTYPES


@dataclass
class EngineConfig:
    model_id: str = "tiny"
    # where the engine runs: "cuda" (the default; raises when no card is
    # visible, never falls back) or "cpu" (the plain attention versions)
    device: str = "cuda"
    # paged KV cache; page_size doubles as the KV block size
    page_size: int = 16
    num_pages: int = 512  # includes the reserved null page 0
    max_seqs: int = 8  # decode batch slots
    max_model_len: int = 2048
    prefill_buckets: tuple = (64, 128, 256, 512)  # padded prefill chunk lengths
    # page-table width ladder (in PAGES); () = auto: min(128,
    # max_pages_per_seq) doubling up to max_pages_per_seq
    page_table_buckets: tuple = ()
    # depth-aware chunked prefill: a chunk's attention work scales with
    # chunk_len * context_depth, so the planner (chunk_len_for) shrinks the
    # chunk bucket once depth * chunk would exceed max_prefill_chunk *
    # prefill_flat_depth, floored at the smallest bucket. The default holds
    # full-size chunks through the first ~8K of context. 0 disables (always
    # max_prefill_chunk)
    prefill_flat_depth: int = 8192
    # decode steps fused into one window with the sampled-token feedback
    # kept on the device
    decode_steps: int = 8
    # decode windows dispatched ahead of result materialization
    pipeline_depth: int = 3
    # cross-request prefill packing: chunks of up to this many DISTINCT
    # sequences ride one prefill call (one weight pass); row-budgeted by
    # lanes_for()
    prefill_lanes: int = 4
    # packed prefill calls dispatched ahead of result materialization
    prefill_pipeline_depth: int = 2
    # at most this many packed prefill calls per scheduler step while decode
    # work is running (0 = unbounded)
    prefill_batches_per_step: int = 2
    # fraction of pages that must stay free for decode growth before
    # admitting a new sequence
    watermark: float = 0.05
    # KV cache storage: None / "bf16" (the model dtype) or "int8" (int8 pages
    # with one f32 scale per (page, token row), quant/kv.py): about half the
    # attention bytes and twice the pages at the same memory. Llama pools
    # only (the MLA latent cache raises)
    kv_cache_dtype: str | None = None
    # weight-only quantization: None (model dtype) or "int8_wo" (int8
    # weights, per-output-channel f32 scales, multiplied by kernel K8 on the
    # card: about half the weight bytes a decode step reads)
    quantize: str | None = None
    # speculative decoding (dynamo_tpu_torch/spec/): verify k draft tokens
    # plus one bonus token in ONE multi-query forward pass, advancing 1..k+1
    # tokens a round with no quality change. Two proposer kinds:
    #   "ngram:k"            - prompt-lookup over the sequence's own history
    #   "draft:<model>:<k>"  - a second registry model drafts k tokens a
    #                          round in one batched step with its own paged
    #                          KV pool, loaded with this engine's quantize /
    #                          kv_cache_dtype; its real probabilities make
    #                          temperature > 0 acceptance the exact rule
    # None = one-token decode windows. Requests with penalties, logprobs or
    # min_tokens ride the decode windows (correct, not speculated)
    speculative: str | None = None
    # capture the step graphs before serving (engine/graphs.py; on the CPU
    # the same calls run the bodies eagerly):
    #   False        - on first use (tests, short-lived engines)
    #   True         - every shape, blocking, before start() returns
    #   "background" - the shapes the first requests need blocking, the
    #                  rest between serving steps after start()
    warmup: bool | str = False
    # multi-tenant QoS (utils/qos.py): admission order by priority class,
    # priority weights composed with the prefill fairness cap, preemption
    # victims lowest class first, and a waiting critical request may evict a
    # lower-class lane. False = classes ignored: FIFO admission and
    # recency-only victims
    qos: bool = True
    # how long a critical request must sit queued with no free slot before
    # the scheduler evicts a lower-class lane for it (the anti-thrash gate)
    qos_preempt_wait_ms: float = 250.0
    # disaggregated prefill, prefill side (disagg/prefill_worker.py): stream
    # the KV over the data plane a prefill chunk at a time, each chunk's
    # finalized pages put on the wire while the next chunk computes, so the
    # decode side holds most KV bytes by the time the completion notification
    # lands. False = one payload after the whole prefill
    kv_stream: bool = True
    # parallel data-plane connections per destination; parts stripe across
    # lanes so one long prompt's parts never hold other requests' transfers
    # behind a single socket
    kv_stream_lanes: int = 2
    # fleet-wide prefix cache (disagg/prefix_fetch.py): when the KV router
    # attaches a remote prefix holder to a request (kv_holder_addr/blocks),
    # pull the matching KV pages from that peer over the data plane instead
    # of recomputing them. The sequence waits in a FETCHING_KV state bounded
    # by prefix_fetch_timeout_s; any failure (timeout, dead peer, "gone")
    # degrades to recompute, never an error to the client
    prefix_fetch: bool = True
    prefix_fetch_timeout_s: float = 5.0
    # only fetch when the holder's advantage over the local prefix cache is
    # at least this many blocks
    prefix_fetch_min_blocks: int = 1
    # live sequence migration (disagg/migrate.py): this engine may hand its
    # in-flight sequences to a peer mid-decode (drain, QoS shed) and adopt a
    # peer's. The committed KV rides the pull data plane (the seq_handoff
    # kind); a failed handoff resumes locally or recomputes from history, so
    # migration is never worse than preempt and recompute. False = the
    # engine refuses adoptions, a drain degrades to attrition and a
    # draining frontend answers a retriable 503
    migration: bool = True
    # deadline belt on one handoff: the destination's KV pull AND the
    # source's wait for the destination's first continuation token; on
    # expiry the source resumes decoding locally
    migration_timeout_s: float = 10.0
    # host-DRAM KV tier (engine/offload.py) capacity in blocks (0 = off)
    host_cache_blocks: int = 0
    # host-DRAM KV tier budget in BYTES (0 = unset): resolved to blocks at
    # engine start at the model's actual per-page wire cost (an int8
    # cache's blocks are about half the bf16 bytes). With both knobs set the
    # larger capacity wins
    host_cache_bytes: int = 0
    # disk KV tier (engine/kv_store.py) budget in BYTES (0 = off; needs a
    # host tier: the ladder demotes HBM -> host -> disk and never skips a
    # rung). Blocks land int8-compressed; restores ride the FETCHING_KV wait
    disk_cache_bytes: int = 0
    # where the disk tier's block files live ("" = $DYNTPU_KV_DISK_DIR, else
    # a fresh temporary directory the store owns and removes)
    disk_cache_dir: str = ""
    # watermark-driven host offload (with a host tier): once page-pool
    # occupancy crosses this fraction, the scheduler drains the coldest
    # refcount-0 cached blocks to the host tier in batches of
    # offload_drain_batch (one gather each). >= 1.0 disables the drain
    offload_watermark: float = 0.90
    offload_drain_batch: int = 32
    # multi-LoRA (dynamo_tpu_torch/lora/): adapter specs this engine serves
    # as ``<base>:<name>`` model names. A spec is ``name`` (a deterministic
    # synthetic adapter), ``name=<dir>`` (adapter_config.json +
    # adapter_model.npz) or ``name=random:<seed>``; a comma string becomes
    # a tuple. Adapters load into one device pool of max_loras + 1 slots
    # (slot 0 the zero adapter for base lanes) and a mixed-adapter batch
    # runs one pass. An adapter not resident loads asynchronously (its
    # requests wait, the rest serve) and unpinned slots evict LRU, the host
    # copy kept. () = LoRA off (no pool; the step bodies are unchanged)
    lora_adapters: tuple = ()
    # device adapter slots besides the zero slot: more adapters than slots
    # multiplex through LRU eviction and hot-swap
    max_loras: int = 4
    # pool rank: an adapter of smaller r zero-pads (exact), a larger r raises
    lora_rank: int = 8

    def __post_init__(self) -> None:
        if not isinstance(self.warmup, bool) and self.warmup != "background":
            # any other string would silently mean the full blocking warmup
            raise ValueError(f"warmup must be True, False, or 'background'; got {self.warmup!r}")
        if self.device not in ("cuda", "cpu") and not str(self.device).startswith("cuda:"):
            raise ValueError(f"device must be 'cuda', 'cuda:N' or 'cpu'; got {self.device!r}")
        if self.prefill_pipeline_depth < 1:
            raise ValueError(
                f"prefill_pipeline_depth must be >= 1; got {self.prefill_pipeline_depth}"
            )
        if self.kv_cache_dtype is not None and self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"kv_cache_dtype must be None or one of {KV_CACHE_DTYPES}; got {self.kv_cache_dtype!r}"
            )
        if self.quantize is not None and self.quantize not in QUANT_MODES:
            raise ValueError(f"quantize must be None or one of {QUANT_MODES}; got {self.quantize!r}")
        if self.qos_preempt_wait_ms < 0:
            raise ValueError(f"qos_preempt_wait_ms must be >= 0; got {self.qos_preempt_wait_ms}")
        if self.prefix_fetch_timeout_s <= 0:
            raise ValueError(f"prefix_fetch_timeout_s must be > 0; got {self.prefix_fetch_timeout_s}")
        if self.kv_stream_lanes < 1:
            raise ValueError(f"kv_stream_lanes must be >= 1; got {self.kv_stream_lanes}")
        if self.migration_timeout_s <= 0:
            raise ValueError(f"migration_timeout_s must be > 0; got {self.migration_timeout_s}")
        if self.offload_drain_batch < 1:
            raise ValueError(f"offload_drain_batch must be >= 1; got {self.offload_drain_batch}")
        if self.host_cache_bytes < 0 or self.host_cache_blocks < 0:
            raise ValueError(
                "host cache capacity must be >= 0; got "
                f"blocks={self.host_cache_blocks} bytes={self.host_cache_bytes}"
            )
        if self.disk_cache_bytes < 0:
            raise ValueError(f"disk_cache_bytes must be >= 0; got {self.disk_cache_bytes}")
        if self.disk_cache_bytes > 0 and not (self.host_cache_blocks > 0 or self.host_cache_bytes > 0):
            raise ValueError(
                "disk_cache_bytes requires a host cache tier "
                "(host_cache_blocks or host_cache_bytes > 0): the KV ladder "
                "demotes HBM -> host -> disk and never skips a rung"
            )
        if any(b <= 0 for b in self.page_table_buckets):
            raise ValueError(f"page_table_buckets must be positive; got {self.page_table_buckets}")
        if self.lora_adapters:
            if isinstance(self.lora_adapters, str):
                # the CLI's comma form: every reader sees a tuple of specs
                self.lora_adapters = tuple(s.strip() for s in self.lora_adapters.split(",") if s.strip())
            else:
                self.lora_adapters = tuple(self.lora_adapters)
            if self.max_loras < 1:
                raise ValueError(f"max_loras must be >= 1; got {self.max_loras}")
            if self.lora_rank < 1:
                raise ValueError(f"lora_rank must be >= 1; got {self.lora_rank}")
            from dynamo_tpu_torch.lora.adapter import parse_adapter_specs

            parse_adapter_specs(self.lora_adapters)  # bad specs fail here, not mid-serving
        # a bad speculative spec must fail at config time, not mid-serving
        self.spec  # noqa: B018 - parse_speculative raises on invalid input

    @property
    def spec(self):
        """Parsed SpecConfig for ``speculative`` (None when disabled)."""
        from dynamo_tpu_torch.spec import parse_speculative

        return parse_speculative(self.speculative)

    @property
    def lora_enabled(self) -> bool:
        return bool(self.lora_adapters)

    @property
    def max_pages_per_seq(self) -> int:
        return -(-self.max_model_len // self.page_size)

    @property
    def table_buckets(self) -> tuple:
        """Resolved page-table width ladder (ascending, last ==
        max_pages_per_seq)."""
        mp = self.max_pages_per_seq
        if self.page_table_buckets:
            ladder = sorted({min(int(b), mp) for b in self.page_table_buckets if b > 0})
            if not ladder or ladder[-1] != mp:
                ladder.append(mp)
            return tuple(ladder)
        widths = []
        w = min(128, mp)
        while w < mp:
            widths.append(w)
            w *= 2
        widths.append(mp)
        return tuple(widths)

    def table_bucket_for(self, n_pages: int) -> int:
        """Smallest ladder width holding ``n_pages`` page-table entries."""
        for w in self.table_buckets:
            if n_pages <= w:
                return w
        raise ValueError(f"{n_pages} pages exceed max_pages_per_seq {self.max_pages_per_seq}")

    @property
    def max_prefill_chunk(self) -> int:
        return max(self.prefill_buckets)

    def chunk_len_for(self, depth: int, backlog_rows: int = 0) -> int:
        """Depth-aware prefill chunk bucket for a chunk starting at context
        ``depth``: the largest bucket b with b * (depth + b) within the
        flat-depth work budget, floored at the smallest bucket, so per-chunk
        work stays roughly flat as prefill advances into a long prompt.
        ``backlog_rows`` (un-prefilled rows pending across sequences) of at
        least two top chunks doubles the budget: fewer, larger calls while
        the backlog dominates."""
        top = self.max_prefill_chunk
        if self.prefill_flat_depth <= 0:
            return top
        budget = top * max(self.prefill_flat_depth, top)
        if backlog_rows >= 2 * top:
            budget *= 2
        best = min(self.prefill_buckets)
        for b in self.prefill_buckets:
            if b * (depth + b) <= budget:
                best = max(best, b)
        return best

    def lanes_for(self, bucket: int) -> int:
        """Packed-prefill lane count for a bucket: bounded by prefill_lanes
        and a ~1024-row budget per call."""
        return max(1, min(self.prefill_lanes, 1024 // bucket))

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must be <= max bucket)."""
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"chunk {n} exceeds max prefill bucket {self.max_prefill_chunk}")
