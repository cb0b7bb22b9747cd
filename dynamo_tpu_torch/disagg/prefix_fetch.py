"""Fleet-wide prefix cache: the cross-worker KV **pull** protocol (port of
``dynamo_tpu/disagg/prefix_fetch.py``: the same frames, byte for byte, with
headers in the port's MessagePack subset, ``utils/wirepack.py``, payload
checksums from the port's XXH3-64, ``llm/_xxh3.py``, and host blocks as
torch tensors, so the port's server and client talk to the reference's
client and server in both directions).

The push data plane (``disagg/dataplane.py``) moves KV the prefill worker
just computed to the decode worker that asked for it. This module is the
other direction: when the KV router places a request on a worker that does
NOT hold its prefix, that worker pulls the matching pages from the peer the
radix indexer says has them, instead of recomputing the whole prefix.

Two halves:

  - ``KvPullServer``: worker-side export service. A peer connects and sends
    a fetch frame naming the *chained sequence hashes* (``llm/tokens.py``,
    the engine block identity carried in KV events) of the prefix blocks it
    wants. The server walks the contiguous leading run of those hashes down
    the engine's tier ladder (``sync_export_prefix``: HBM pages, their
    gather and host copy enqueued on the engine thread, then host-tier
    blocks) and streams the data back as checksummed parts (one a tier) on
    the same connection. A ``seq_handoff`` request (live migration,
    ``disagg/migrate.py``) names a live sequence and is served from its own
    pages (``sync_export_sequence``). A leading miss returns a clean
    ``gone`` frame, never a timeout: the requester must fall back to
    recompute immediately. A LoRA request's hashes are salted with its
    adapter's uid (the scheduler's ``_lora_salt``), so a holder's adapter
    prefix answers a peer's request for the same adapter and never a base
    request or another adapter's: those hashes are not on the holder.

  - ``PrefixFetchClient``: requester side, driven by the engine scheduler (a
    thread without an event loop): ``fetch()`` schedules the coroutine onto
    the serving loop via ``run_coroutine_threadsafe`` and hands back a
    concurrent Future the scheduler polls each step while the sequence waits
    in its FETCHING_KV state. Every failure mode (timeout, refused
    connection, holder death mid-stream, checksum mismatch, ``gone``)
    resolves the future with a non-hit result: the scheduler then
    recomputes; a fetch never errors a request.

Wire format (the push plane's framing: ``u32 len | msgpack header [|
payload]``):

    request:  {kind: "prefix_fetch", hashes: [u64, ...]}
              | {kind: "seq_handoff", seq_id, hashes: [u64, ...]}
    response: 1..N part frames, each
              {status: "ok", part_seq, part_total, block_from, block_to,
               tier: "hbm"|"host", shape, dtype, xxh3, cat_axis
               [, scales, scales_shape, scales_dtype]} | payload
              or a single payload-less {status: "gone"} / {status:
              "error", error} frame.

``block_from``/``block_to`` index into the REQUESTED hash list, so the
requester maps parts onto its own freshly allocated pages. Int8 KV caches
ship int8 page data with the per-row scale plane riding the part header, as
the push protocol does; the parts land in ``ModelRunner.inject_pages``,
whose ``scatter_pages_wire`` converts dtypes, so mixed-dtype peers
interoperate.

The server honours the fault plan (``disagg/faults.py``,
``DYNTPU_FAULT_DATAPLANE``) per kind: a delay before the export, a part
dropped (the requester's timeout fires) or sent with a wrong checksum.
"""

from __future__ import annotations

import asyncio
import socket
import time
from dataclasses import dataclass, field
from typing import Optional

from dynamo_tpu_torch.disagg.dataplane import _LEN, MAX_HEADER
from dynamo_tpu_torch.disagg.faults import active_plan
from dynamo_tpu_torch.llm._xxh3 import xxh3_64
from dynamo_tpu_torch.llm.remote_prefill import _torch_dtype, host_tensor, tensor_bytes, wire_dtype_name
from dynamo_tpu_torch.quant.kv import wire_concat
from dynamo_tpu_torch.utils import get_logger, wirepack
from dynamo_tpu_torch.utils.prometheus import Histogram, render_family

log = get_logger("disagg.prefix_fetch")

# whole-fetch latency: localhost pulls are ms-scale, a cross-host pull of a
# long prefix reaches seconds
_FETCH_SECONDS_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                          0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _pack_part(seq: int, total: int, block_from: int, block_to: int, tier: str, data,
               axis: int) -> tuple[bytes, memoryview]:
    """One response part -> (header bytes, payload memoryview). ``data`` is
    a host tensor, or the int8 {"q","s"} wire dict (the scale plane rides
    the header)."""
    scales = None
    if isinstance(data, dict):
        scales = data["s"]
        data = data["q"]
    payload = tensor_bytes(data)
    fields = {
        "status": "ok",
        "part_seq": seq,
        "part_total": total,
        "block_from": block_from,
        "block_to": block_to,
        "tier": tier,
        "shape": list(data.shape),
        "dtype": wire_dtype_name(data.dtype),
        "xxh3": xxh3_64(payload),
        "cat_axis": axis,
    }
    if scales is not None:
        fields["scales"] = bytes(tensor_bytes(scales))
        fields["scales_shape"] = list(scales.shape)
        fields["scales_dtype"] = wire_dtype_name(scales.dtype)
    return wirepack.packb(fields), payload


@dataclass
class FetchedPart:
    """One pulled prefix range, ready for ``inject_pages``."""

    block_from: int  # indices into the requested hash list
    block_to: int
    data: object  # a host tensor, or the int8 {"q","s"} wire dict
    cat_axis: int
    tier: str = ""


@dataclass
class PrefixFetchResult:
    """Terminal state of one fetch; every failure mode is a status, never an
    exception: the scheduler's fallback ladder keys off it."""

    status: str  # "hit" | "gone" | "timeout" | "error"
    blocks: int = 0  # contiguous leading blocks received
    bytes: int = 0  # payload bytes received
    parts: list = field(default_factory=list)  # [FetchedPart], block order
    error: str = ""


class KvPullServer:
    """Worker-side KV export service: serves prefix pulls from this engine's
    tier ladder and migration pulls from its live sequences."""

    def __init__(self, engine, host: str = "0.0.0.0", advertise_host: Optional[str] = None):
        self.engine = engine
        self.host = host
        self.advertise_host = advertise_host
        self.port: Optional[int] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._writers: set[asyncio.StreamWriter] = set()
        self.served = 0  # fetches answered with >= 1 block
        self.gone = 0  # clean leading-miss responses
        self.errors = 0
        self.served_blocks = {"hbm": 0, "host": 0}
        self.bytes_sent = 0
        self.handoffs_served = 0  # seq_handoff pulls answered

    @property
    def address(self) -> str:
        host = self.advertise_host
        if host is None:
            host = socket.gethostname() if self.host in ("0.0.0.0", "::") else self.host
        return f"{host}:{self.port}"

    async def start(self, port: int = 0) -> "KvPullServer":
        self._server = await asyncio.start_server(self._on_conn, self.host, port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("kv pull server listening on %s", self.address)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for w in list(self._writers):
                w.close()
            await self._server.wait_closed()

    # ---------------- wire ----------------

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        self._writers.add(writer)
        try:
            while True:
                raw = await reader.readexactly(_LEN.size)
                (hlen,) = _LEN.unpack(raw)
                if hlen > MAX_HEADER:
                    raise ValueError(f"prefix fetch header too large: {hlen}")
                header = wirepack.unpackb(await reader.readexactly(hlen))
                kind = header.get("kind")
                if kind not in ("prefix_fetch", "seq_handoff"):
                    raise ValueError(f"unexpected frame kind {kind!r}")
                await self._serve_fetch(writer, list(header.get("hashes", ())), kind=kind,
                                        seq_id=str(header.get("seq_id", "") or ""))
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        except Exception:
            log.exception("kv pull connection from %s failed", peer)
        finally:
            self._writers.discard(writer)
            writer.close()

    async def _write_status(self, writer, status: str, error: str = "") -> None:
        fields = {"status": status, "part_total": 0}
        if error:
            fields["error"] = error
        header = wirepack.packb(fields)
        writer.write(_LEN.pack(len(header)))
        writer.write(header)
        await writer.drain()

    async def _serve_fetch(self, writer, hashes: list[int], kind: str = "prefix_fetch", seq_id: str = "") -> None:
        engine = self.engine
        plan = active_plan()
        if plan is not None:
            delay = plan.delay_s(kind)
            if delay > 0:
                await asyncio.sleep(delay)
        export = None
        if hashes and engine is not None:
            try:
                if kind == "seq_handoff":
                    # live migration: the named sequence's OWN page run,
                    # falling back to the prefix cache once it is released
                    export = await engine.run_on_engine(lambda: engine.sync_export_sequence(seq_id, hashes))
                else:
                    export = await engine.run_on_engine(lambda: engine.sync_export_prefix(hashes))
            except Exception:
                log.exception("prefix export failed")
                self.errors += 1
                await self._write_status(writer, "error", "export failed")
                return
        if export is None:
            # leading block in no tier: a clean miss the requester can act on
            # immediately (it recomputes), never a timeout
            self.gone += 1
            await self._write_status(writer, "gone")
            return
        n_dev, dev_future, host_blocks, axis = export
        try:
            parts = []
            if n_dev:
                # resolve the device-to-host copy off the loop; the gather
                # was enqueued on the engine thread inside the export
                parts.append((0, n_dev, "hbm", await asyncio.wrap_future(dev_future)))
            if host_blocks:
                hdata = wire_concat(host_blocks, axis=axis) if len(host_blocks) > 1 else host_blocks[0]
                parts.append((n_dev, n_dev + len(host_blocks), "host", hdata))
        except Exception:
            log.exception("prefix export staging failed")
            self.errors += 1
            await self._write_status(writer, "error", "staging failed")
            return
        total = len(parts)
        for seq, (b0, b1, tier, data) in enumerate(parts):
            if plan is not None and plan.should_drop(kind):
                # injected black hole: the frame is never written, so the
                # requester's own timeout must unwedge it
                log.warning("fault: dropping %s part %d", kind, seq)
                continue
            header, payload = _pack_part(seq, total, b0, b1, tier, data, axis)
            if plan is not None and plan.should_corrupt(kind):
                fields = wirepack.unpackb(header)
                fields["xxh3"] = (fields["xxh3"] ^ 1) & 0xFFFFFFFFFFFFFFFF
                header = wirepack.packb(fields)
            writer.write(_LEN.pack(len(header)))
            writer.write(header)
            writer.write(payload)
            await writer.drain()
            self.served_blocks[tier] = self.served_blocks.get(tier, 0) + (b1 - b0)
            self.bytes_sent += payload.nbytes
        self.served += 1
        if kind == "seq_handoff":
            self.handoffs_served += 1

    # ---------------- metrics ----------------

    def render_metrics(self) -> str:
        return "".join([
            render_family(
                "dynamo_prefix_fetch_served_total", "counter",
                "prefix pulls answered, by result",
                [({"result": "hit"}, self.served),
                 ({"result": "gone"}, self.gone),
                 ({"result": "error"}, self.errors)],
            ),
            render_family(
                "dynamo_prefix_fetch_served_blocks_total", "counter",
                "KV blocks exported to pulling peers, by tier",
                [({"tier": t}, n) for t, n in sorted(self.served_blocks.items())],
            ),
            render_family(
                "dynamo_prefix_fetch_served_bytes_total", "counter",
                "KV payload bytes exported to pulling peers",
                [({}, self.bytes_sent)],
            ),
        ])


class PrefixFetchClient:
    """Requester side: pulls a prefix's blocks from a peer's KvPullServer.

    ``fetch()`` is thread-safe (the engine scheduler calls it from the
    engine thread); the returned concurrent Future ALWAYS resolves to a
    PrefixFetchResult: timeouts, dead peers and protocol errors become
    statuses, so a fetch can never wedge or error admission."""

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop], timeout_s: float = 5.0):
        self._loop = loop
        self.timeout_s = timeout_s
        self.requests = 0
        self.results: dict[str, int] = {}
        self.blocks_received = 0
        self.bytes_received = 0
        self.fetch_seconds = Histogram(
            "dynamo_prefix_fetch_client_seconds",
            "wall time of one prefix pull, connection to last part",
            _FETCH_SECONDS_BUCKETS,
        )

    def fetch(self, addr: str, hashes: list[int], timeout_s: Optional[float] = None, kind: str = "prefix_fetch",
              seq_id: str = ""):
        """Start a pull; returns a concurrent.futures.Future[PrefixFetchResult].
        ``kind="seq_handoff"`` with ``seq_id`` pulls a live sequence's own
        pages (live migration)."""
        if self._loop is None or self._loop.is_closed():
            raise RuntimeError("prefix fetch client has no running event loop")
        return asyncio.run_coroutine_threadsafe(
            self._fetch(addr, list(hashes), timeout_s or self.timeout_s, kind, seq_id), self._loop
        )

    async def _fetch(self, addr: str, hashes: list[int], timeout_s: float, kind: str = "prefix_fetch",
                     seq_id: str = "") -> PrefixFetchResult:
        self.requests += 1
        t0 = time.monotonic()
        try:
            res = await asyncio.wait_for(self._fetch_inner(addr, hashes, kind, seq_id), timeout_s)
        except asyncio.TimeoutError:
            res = PrefixFetchResult(status="timeout")
        except asyncio.CancelledError:
            raise
        except Exception as e:
            res = PrefixFetchResult(status="error", error=f"{type(e).__name__}: {e}")
        self.results[res.status] = self.results.get(res.status, 0) + 1
        self.blocks_received += res.blocks
        self.bytes_received += res.bytes
        self.fetch_seconds.observe(time.monotonic() - t0)
        if res.status != "hit":
            log.debug("prefix fetch from %s: %s %s", addr, res.status, res.error)
        return res

    async def _fetch_inner(self, addr: str, hashes: list[int], kind: str = "prefix_fetch",
                           seq_id: str = "") -> PrefixFetchResult:
        host, _, port = addr.rpartition(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        try:
            fields = {"kind": kind, "hashes": hashes}
            if seq_id:
                fields["seq_id"] = seq_id
            req = wirepack.packb(fields)
            writer.write(_LEN.pack(len(req)))
            writer.write(req)
            await writer.drain()
            parts: list[FetchedPart] = []
            total: Optional[int] = None
            nbytes_total = 0
            while total is None or len(parts) < total:
                raw = await reader.readexactly(_LEN.size)
                (hlen,) = _LEN.unpack(raw)
                if hlen > MAX_HEADER:
                    raise ValueError(f"prefix fetch header too large: {hlen}")
                header = wirepack.unpackb(await reader.readexactly(hlen))
                status = header.get("status")
                if status == "gone":
                    return PrefixFetchResult(status="gone")
                if status != "ok":
                    return PrefixFetchResult(status="error", error=str(header.get("error", "bad status")))
                shape = tuple(header["shape"])
                numel = 1
                for d in shape:
                    numel *= int(d)
                nbytes = _torch_dtype(header["dtype"]).itemsize * numel
                payload = await reader.readexactly(nbytes)
                if xxh3_64(payload) != header["xxh3"]:
                    return PrefixFetchResult(status="error", error="checksum mismatch")
                data: object = host_tensor(payload, header["dtype"], shape)
                if header.get("scales") is not None:
                    data = {"q": data, "s": host_tensor(header["scales"], header["scales_dtype"],
                                                        header["scales_shape"])}
                parts.append(FetchedPart(
                    block_from=int(header["block_from"]),
                    block_to=int(header["block_to"]),
                    data=data,
                    cat_axis=int(header.get("cat_axis", 2)),
                    tier=str(header.get("tier", "")),
                ))
                total = max(1, int(header["part_total"]))
                nbytes_total += nbytes
            parts.sort(key=lambda p: p.block_from)
            # only the contiguous leading run is usable as cached prefix
            blocks = 0
            usable = []
            for p in parts:
                if p.block_from != blocks:
                    break
                usable.append(p)
                blocks = p.block_to
            if blocks == 0:
                return PrefixFetchResult(status="gone")
            return PrefixFetchResult(status="hit", blocks=blocks, bytes=nbytes_total, parts=usable)
        finally:
            writer.close()

    # ---------------- metrics ----------------

    def render_metrics(self) -> str:
        results = {s: self.results.get(s, 0) for s in ("hit", "gone", "timeout", "error")}
        return "".join([
            render_family(
                "dynamo_prefix_fetch_client_requests_total", "counter",
                "prefix pulls issued to peers, by terminal result",
                [({"result": s}, n) for s, n in sorted(results.items())],
            ),
            render_family(
                "dynamo_prefix_fetch_client_blocks_total", "counter",
                "KV blocks pulled off peers (contiguous usable runs)",
                [({}, self.blocks_received)],
            ),
            render_family(
                "dynamo_prefix_fetch_client_bytes_total", "counter",
                "KV payload bytes pulled off peers (at the wire KV dtype)",
                [({}, self.bytes_received)],
            ),
            self.fetch_seconds.render(),
        ])
