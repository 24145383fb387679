"""Prefill→decode paged-KV handoff for disaggregated serving (counterpart
of gofr_tpu/tpu/handoff.py; the wire is byte for byte JAX's, so a JAX
worker and a port worker pair).

Role-split engines (``ENGINE_ROLE``, gpu/engine.py) separate the two phases
continuous batching otherwise interleaves on one card: a *prefill* worker
runs prompt prefill and ships the resulting full KV pages here; a *decode*
worker imports them as HOST-tier prefix-cache nodes (gpu/prefix.py
``insert_host``), so the next admission of that prompt gets a prefix hit
and the page upload rides the ordinary swap-in on the in-flight queue.

Two wire modes share one JOIN (``_MAGIC`` + hello + int32 ACK), and the
ACK **is** the version negotiation:

- **GOFR-HANDOFF1 (blob)**: after ``ACK_OK`` each transfer is ONE frame
  ``<i meta_nbytes><meta JSON><payload>`` carrying every page of the
  prompt, sent once the whole prefill finished.
- **GOFR-HANDOFF2 (streaming)**: the hello adds ``version: 2`` and
  ``streams: N``; a v2 server answers ``ACK_OK_STREAM`` and the exporter
  opens ``HANDOFF_STREAMS`` connections. A transfer becomes page-granular
  chunks (``begin`` / ``pages`` / ``end`` / ``abort``, the same framing)
  shipped WHILE later chunks of the same prompt still prefill: the
  engine's chunk fold stages the pages already written
  (``GenerateEngine._stream_handoff_chunk``), the exporter waits for their
  copies outside every engine lock and writes them as scatter-gather
  memoryviews (``fleet.channel.sendmsg_all``) round-robin across the
  streams. Cross-stream order is rebuilt from ``start_page``, and the
  importer registers each newly contiguous page prefix at once. A
  HANDOFF1 peer answers the same hello with plain ``ACK_OK`` and the
  exporter negotiates DOWN to one blob frame at activation.

JOIN gates (both modes): the hello names the exporter's KV pool dtype
(``bf16`` | ``int8`` | ``int4``), the adapter-set digest, the base-weight
epoch and the pool's tp degree (1 on the port); a mismatch is rejected at
JOIN with a distinct ACK code before any page moves. Both sides cap frames
at ``MAX_FRAME_BYTES``.

Planes on the wire are named by numpy's dtype names (``bfloat16`` as
``ml_dtypes`` names it); the port reads and writes them as torch tensors
through a ``uint8`` view, so it needs no ``ml_dtypes``. Received planes
land straight in (on the card, pinned) host tensors: the decode worker's
swap-in uploads them without a blocking copy.

Failure contract: every chunk send and the final ACK wait are bounded by
``min(handoff_timeout_s, the request's remaining deadline)``; a stuck or
severed transfer completes the request with a 504 (``where="handoff"``).
The prefill side's pages were retained by its own prefix cache before the
export, and the decode side registers only refcount-free host payloads (a
partial import is a shorter valid prefix chain), so a transfer severed at
any byte leaks no pool page on either side. JAX's chaos points (``kv.
handoff*``) are not ported (ROADMAP.md Queue A 9).
"""

from __future__ import annotations

import json
import math
import os
import queue
import socket
import struct
import threading
import time

import numpy as np
import torch

from gofr_tpu_torch.fleet.channel import MAX_FRAME_BYTES, sendmsg_all
from gofr_tpu_torch.http.errors import DeadlineExceeded

_MAGIC = b"GOFR-HANDOFF1\n"
_I32 = struct.Struct("<i")

# GOFR-HANDOFF2: the version rides the JOIN hello and the ACK picks the
# framing — the magic stays HANDOFF1 so both generations share one JOIN
PROTOCOL_VERSION = 2

ACK_OK = 0  # JOIN accepted, HANDOFF1 blob frames on this connection
ACK_REJECTED = 1
ACK_DTYPE_MISMATCH = 2
# the P/D split must agree on which adapters exist and on the base-weight
# epoch; absent fields in the hello (a pre-adapter peer) gate on neither
ACK_ADAPTER_MISMATCH = 3
ACK_EPOCH_MISMATCH = 4
ACK_OK_STREAM = 5  # JOIN accepted, HANDOFF2 chunk frames on this connection
# the pool's tp degree; absent means a pre-sharding peer (tp 1)
ACK_SHARD_MISMATCH = 6

# the JOIN hello is a few dozen bytes of JSON; anything bigger is not ours
_MAX_HELLO_BYTES = 4096

# the streaming import keeps per-transfer reassembly state across stream
# connections; bound it so a crashed exporter's orphans can't accumulate
_MAX_SESSIONS = 64

# the pools' plane dtypes by their numpy (and ml_dtypes) names, the wire's
# spelling: K/V in the model's dtype, int8 rows, packed int4 rows, bf16 scales
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
           "int8": torch.int8, "uint8": torch.uint8}
_NAMES = {v: k for k, v in _DTYPES.items()}


def engine_kv_dtype(engine) -> str:
    """The engine's KV pool dtype as it rides the wire: the canonical
    ENGINE_KV_DTYPE spelling ('' quantize means the dense bf16 pool)."""
    return getattr(engine, "kv_quantize", "") or "bf16"


class HandoffClosed(ConnectionError):
    """The peer went away mid-frame (sever, crash)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes; a short read mid-frame is a protocol error."""
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            raise HandoffClosed(f"handoff peer closed mid-read ({len(buf)}/{n} bytes)")
        buf.extend(part)
    return bytes(buf)


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` from the socket, or raise HandoffClosed."""
    got = 0
    while got < view.nbytes:
        n = sock.recv_into(view[got:], view.nbytes - got)
        if not n:
            raise HandoffClosed(f"handoff peer closed mid-read ({got}/{view.nbytes} bytes)")
        got += n


def _dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"handoff: unknown plane dtype {name!r}") from None


def _plane_meta(planes) -> list[dict]:
    return [{"dtype": _NAMES[t.dtype], "shape": [int(d) for d in t.shape]} for t in planes]


def _byte_view(t: torch.Tensor) -> memoryview:
    """A flat uint8 memoryview over a host tensor's bytes, without a copy
    for a contiguous tensor (``.numpy()`` of a bf16 tensor raises; its
    uint8 view does not)."""
    return memoryview(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy())


def encode_frame(toks, payloads: list[tuple], nbytes_page: int, kv_dtype: str = "") -> bytes:
    """One HANDOFF1 blob frame: meta-length + meta JSON + concatenated
    plane bytes (tpu/handoff.py:148). ``payloads`` holds one tuple of host
    tensors per full page, in chain order; ``kv_dtype`` tags the pool
    layout the planes were quantized for."""
    meta = json.dumps({
        "toks": np.asarray(toks, np.int64).tolist(),
        "n_pages": len(payloads),
        "nbytes_page": int(nbytes_page),
        "kv_dtype": str(kv_dtype),
        "planes": _plane_meta(payloads[0]),
    }).encode("utf-8")
    frame = b"".join([_I32.pack(len(meta)), meta,
                      *(_byte_view(a) for page in payloads for a in page)])
    if len(frame) > MAX_FRAME_BYTES:
        raise ValueError(f"handoff: refusing to send a {len(frame)}-byte frame "
                         f"(cap {MAX_FRAME_BYTES}); {len(payloads)} pages")
    return frame


def decode_frame(sock: socket.socket, pin: bool = False) -> tuple[np.ndarray, list[tuple], int, str]:
    """Read one HANDOFF1 blob frame off ``sock``: (prompt tokens, per-page
    plane tuples as host tensors, pinned with ``pin``, nbytes_page,
    kv_dtype tag — "" from a pre-tag peer). Raises HandoffClosed on sever,
    ValueError on a frame that lies about its size."""
    (meta_len,) = _I32.unpack(_recv_exact(sock, _I32.size))
    if not 0 < meta_len <= MAX_FRAME_BYTES:
        raise ValueError(f"handoff: frame advertises {meta_len} meta bytes — corrupt stream")
    meta = json.loads(_recv_exact(sock, meta_len).decode("utf-8"))
    toks = np.asarray(meta["toks"], np.int32)
    payloads = _recv_planes(sock, meta["planes"], int(meta["n_pages"]), pin)
    return toks, payloads, int(meta["nbytes_page"]), str(meta.get("kv_dtype", ""))


def _recv_planes(sock: socket.socket, planes: list, n_pages: int, pin: bool) -> list[tuple]:
    """Read ``n_pages`` pages' plane payloads as self-described by the
    frame or chunk meta, each straight into a host tensor of its own (a
    ``recv_into`` its uint8 view), with the same loud size cap."""
    dtypes = [_dtype(p["dtype"]) for p in planes]
    shapes = [tuple(int(d) for d in p["shape"]) for p in planes]
    sizes = [math.prod(sh) * dt.itemsize for sh, dt in zip(shapes, dtypes)]
    if not 0 < n_pages * sum(sizes) <= MAX_FRAME_BYTES:
        raise ValueError(f"handoff: frame advertises {n_pages} pages x {sum(sizes)} bytes "
                         f"(cap {MAX_FRAME_BYTES}) — corrupt stream")
    payloads: list[tuple] = []
    for _ in range(n_pages):
        page = []
        for sh, dt, size in zip(shapes, dtypes, sizes):
            raw = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
            _recv_into(sock, memoryview(raw.numpy()))
            page.append(raw.view(dt).reshape(sh))
        payloads.append(tuple(page))
    return payloads


def chunk_parts(meta: dict, payload_parts=()) -> list:
    """One HANDOFF2 chunk as a scatter-gather buffer list (tpu/handoff.py:
    220): ``<i meta_nbytes> <meta JSON> <payload>``, the payload as
    memoryviews over the original tensors. ``meta["kind"]`` is
    begin|pages|end|abort; ``pages`` metas are self-describing
    (``planes``), so a chunk parses on any stream before its ``begin``."""
    meta_b = json.dumps(meta).encode("utf-8")
    return [_I32.pack(len(meta_b)), meta_b, *payload_parts]


def read_chunk(sock: socket.socket, pin: bool = False) -> tuple[dict, list[tuple], int]:
    """Read one HANDOFF2 chunk: (meta, page payloads — empty unless
    ``kind == "pages"`` —, payload byte count)."""
    (meta_len,) = _I32.unpack(_recv_exact(sock, _I32.size))
    if not 0 < meta_len <= MAX_FRAME_BYTES:
        raise ValueError(f"handoff: chunk advertises {meta_len} meta bytes — corrupt stream")
    meta = json.loads(_recv_exact(sock, meta_len).decode("utf-8"))
    payloads: list[tuple] = []
    nbytes = 0
    if meta.get("kind") == "pages":
        payloads = _recv_planes(sock, meta["planes"], int(meta["n_pages"]), pin)
        nbytes = sum(a.nbytes for page in payloads for a in page)
    return meta, payloads, nbytes


def _register_handoff_metrics(metrics) -> None:
    """The registry's record-by-name API drops writes to unregistered
    names, so both endpoints declare the transfer metrics up front
    (idempotent)."""
    metrics.new_counter("app_tpu_kv_handoff_pages_total",
                        "KV pages shipped between role-split workers")
    metrics.new_counter("app_tpu_kv_handoff_bytes_total",
                        "KV handoff wire bytes (frame size, export side)")
    metrics.new_counter("app_tpu_kv_handoff_overlap_bytes_total",
                        "KV handoff bytes shipped while the slot was still prefilling "
                        "(the streaming pipeline's overlap)")
    metrics.new_gauge("app_tpu_kv_handoff_overlap_ratio",
                      "overlap bytes / total export bytes since boot "
                      "(1.0 = every byte hid behind prefill compute)")
    metrics.new_gauge("app_tpu_kv_handoff_streams",
                      "negotiated parallel handoff streams (0 = HANDOFF1 blob mode)")
    metrics.new_histogram("app_tpu_kv_handoff_seconds",
                          "prefill-side handoff latency: activation to ACK")


class HandoffJob:
    """One staged BLOB export (HANDOFF1 / ``handoff_streams=0``): what the
    exporter thread needs to ship a slot's prompt pages and settle the
    request, captured under the engine state lock at activation.
    ``payloads`` are the pages' ``executor.Readback``s, dispatched under the
    lock; the exporter waits on them outside it."""

    __slots__ = ("request", "prompt_tokens", "first_token", "payloads", "nbytes_page", "t0")

    def __init__(self, request, prompt_tokens, first_token, payloads, nbytes_page, t0):
        self.request = request
        self.prompt_tokens = prompt_tokens
        self.first_token = first_token
        self.payloads = payloads
        self.nbytes_page = nbytes_page
        self.t0 = t0


class StreamTransfer:
    """One STREAMING export (HANDOFF2): created at the first full page of a
    still-prefilling slot or at activation. The engine thread appends page
    readbacks in chain order (``add``, under its state lock — append-only,
    so the exporter thread reads a stable prefix without a lock) and flips
    ``finished`` at activation; the exporter thread owns every other
    field."""

    __slots__ = ("request", "prompt_tokens", "nbytes_page", "t0", "xfer", "staged", "sent_pages",
                 "sent_bytes", "overlap_bytes", "first_token", "finished", "t_activate", "begun",
                 "seq", "failed", "settled")

    def __init__(self, request, prompt_tokens, nbytes_page, t0, xfer):
        self.request = request
        self.prompt_tokens = prompt_tokens
        self.nbytes_page = int(nbytes_page)
        self.t0 = t0
        self.xfer = xfer
        self.staged: list = []  # page readbacks, chain order
        self.sent_pages = 0
        self.sent_bytes = 0
        self.overlap_bytes = 0
        self.first_token: int | None = None
        self.finished = False
        self.t_activate: float | None = None
        self.begun = False
        self.seq = 0
        self.failed = False
        self.settled = False

    @property
    def staged_pages(self) -> int:
        return len(self.staged)

    def add(self, payloads: list) -> None:
        self.staged.extend(payloads)


def _host_pages(engine, staged: list) -> list[tuple]:
    """Wait for staged page readbacks (``executor.Readback``, timed) outside
    every engine lock, and price them into the perf plane as
    off-device-thread work: the copies' time on the card's events (the
    host clock's on the CPU)."""
    host = [tuple(rb.wait()) for rb in staged]
    plane = getattr(engine, "perf", None)
    if plane is not None and host:
        flops, bytes_ = plane.model.handoff_export(len(host))
        plane.note_external("handoff_export", sum(rb.seconds() for rb in staged), flops,
                            bytes_, time.monotonic())
    return host


class HandoffExporter:
    """Prefill-side export thread (tpu/handoff.py:330): ships staged
    transfers to the decode worker's HandoffServer, lazily (re)dialing and
    negotiating the wire mode at JOIN. Transfers are serial on this thread,
    but a streaming transfer's chunks overlap the exporting engine's
    remaining prefill: the engine stages pages at each chunk fold, this
    thread drains them while the next chunk runs on the card."""

    def __init__(self, target: str, *, engine=None, timeout_s: float = 5.0, streams: int = 2,
                 chunk_pages: int = 4, pace_mbps: float = 0.0, logger=None, metrics=None):
        host, _, port = target.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self.timeout_s = max(0.1, float(timeout_s))
        self.streams = max(0, int(streams))
        self.chunk_pages = max(1, int(chunk_pages))
        # an egress bandwidth cap (HANDOFF_PACE_MBPS): sleep nbytes/rate
        # after each wire write; 0 = off
        self.pace_mbps = max(0.0, float(pace_mbps))
        self.engine = engine
        self.logger = logger
        self.metrics = metrics
        if metrics is not None:
            _register_handoff_metrics(metrics)
        self._sock: socket.socket | None = None  # blob-mode connection
        self._socks: list[socket.socket] = []    # stream-mode connections
        self._mode: str | None = None            # None until first JOIN
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = threading.Event()
        self._stats = {"exported": 0, "failed": 0, "pages": 0, "bytes": 0, "overlap_bytes": 0}
        self._stream_bytes: list[int] = []
        self._stream_seconds: list[float] = []
        self._xfer_seq = 0
        self._xfer_tag = f"{os.getpid():x}.{id(self) & 0xFFFFFF:x}"
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="kv-handoff-export", daemon=True)
        self._thread.start()

    # -- connection / negotiation ----------------------------------------------

    def _hello(self) -> bytes:
        """JOIN hello: kv dtype, adapter-set digest, base-weight epoch, tp
        degree, and the HANDOFF2 announcement when streaming is configured
        (a HANDOFF1 server ignores the extra keys and ACKs plain OK)."""
        hello = {
            "kv_dtype": engine_kv_dtype(self.engine),
            "adapters": str(getattr(self.engine, "adapters_digest", lambda: "")()),
            "weights_epoch": int(getattr(self.engine, "weights_epoch", 0) or 0),
            "kv_shards": int(getattr(self.engine, "kv_shards", 1) or 1),
        }
        if self.streams > 0:
            hello["version"] = PROTOCOL_VERSION
            hello["streams"] = self.streams
        return json.dumps(hello).encode("utf-8")

    def _dial(self) -> tuple[socket.socket, int]:
        """One connection's JOIN: (socket, ACK status) when accepted;
        HandoffClosed with the configuration hint on a rejection or sever."""
        s = socket.create_connection((self.host, self.port), timeout=self.timeout_s)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        hello = self._hello()
        try:
            s.sendall(_MAGIC + _I32.pack(len(hello)) + hello)
            (status,) = _I32.unpack(_recv_exact(s, _I32.size))
        except (OSError, HandoffClosed):
            s.close()
            raise
        if status not in (ACK_OK, ACK_OK_STREAM):
            s.close()
            if status == ACK_ADAPTER_MISMATCH:
                raise HandoffClosed(
                    "decode worker rejected JOIN (ACK_ADAPTER_MISMATCH): the P/D sides disagree "
                    "on the loaded adapter set (register the same adapters — names, ranks, "
                    "scales — on both)")
            if status == ACK_EPOCH_MISMATCH:
                raise HandoffClosed(
                    "decode worker rejected JOIN (ACK_EPOCH_MISMATCH): the P/D sides are at "
                    "different base-weight epochs (a live hot-swap must land on both before "
                    "pages move)")
            if status == ACK_SHARD_MISMATCH:
                raise HandoffClosed(
                    "decode worker rejected JOIN (ACK_SHARD_MISMATCH): the P/D sides shard the "
                    f"KV pool differently (local tp degree "
                    f"{int(getattr(self.engine, 'kv_shards', 1) or 1)}; ENGINE_KV_SHARD and the "
                    "mesh tp size must agree across the split)")
            raise HandoffClosed(
                f"decode worker rejected JOIN (status {status}): kv dtype "
                f"{engine_kv_dtype(self.engine)!r} does not match the import pool "
                "(ENGINE_KV_DTYPE must agree across the P/D split)")
        return s, status

    def _negotiate(self) -> None:
        """Resolve the wire mode on first use: ACK_OK_STREAM selects the
        chunked pipeline over up to ``streams`` connections (a failed extra
        dial degrades to fewer streams); plain ACK_OK from a HANDOFF1 peer
        negotiates DOWN to blob mode on that same connection."""
        if self._mode is not None:
            return
        s, status = self._dial()
        if status == ACK_OK_STREAM and self.streams > 0:
            socks = [s]
            for _ in range(1, self.streams):
                try:
                    s2, st2 = self._dial()
                except (OSError, HandoffClosed):
                    break
                if st2 != ACK_OK_STREAM:
                    s2.close()
                    break
                socks.append(s2)
            self._socks = socks
            self._mode = "stream"
            with self._lock:
                self._stream_bytes = [0] * len(socks)
                self._stream_seconds = [0.0] * len(socks)
            if self.metrics is not None:
                self.metrics.set_gauge("app_tpu_kv_handoff_streams", len(socks))
            if self.logger is not None:
                self.logger.infof("kv handoff: GOFR-HANDOFF2 streaming over %d stream(s)",
                                  len(socks))
        else:
            self._sock = s
            self._mode = "blob"
            if self.metrics is not None:
                self.metrics.set_gauge("app_tpu_kv_handoff_streams", 0)
            if self.logger is not None and self.streams > 0:
                self.logger.warn("kv handoff: peer speaks GOFR-HANDOFF1 — negotiated down to "
                                 "blob mode (transfer will not overlap prefill)")

    def _connect(self) -> socket.socket:
        """The blob-mode connection."""
        self._negotiate()
        if self._mode != "blob" or self._sock is None:
            raise HandoffClosed("handoff: blob send without a blob-mode JOIN")
        return self._sock

    def _sever(self) -> None:
        for s in ([self._sock] if self._sock is not None else []) + self._socks:
            try:
                s.close()
            except OSError:
                pass
        self._sock = None
        self._socks = []
        self._mode = None  # the next transfer re-dials and re-negotiates

    def _pace(self, nbytes: int) -> None:
        if self.pace_mbps > 0.0 and nbytes > 0:
            time.sleep(nbytes / (self.pace_mbps * 1e6))

    def _budget(self, req) -> float:
        """Per-write budget: the tighter of the handoff timeout and the
        request's remaining deadline, per chunk in streaming mode."""
        budget = self.timeout_s
        if req is not None and req.deadline is not None:
            budget = min(budget, max(0.05, req.deadline - time.monotonic()))
        return budget

    # -- engine-facing API -----------------------------------------------------

    def submit(self, job: HandoffJob) -> None:
        self._q.put(job)

    def begin_stream(self, request, prompt_tokens, nbytes_page, t0: float) -> StreamTransfer:
        """A transfer handle for a (possibly still-prefilling) slot; nothing
        moves until ``kick``."""
        with self._lock:
            self._xfer_seq += 1
            n = self._xfer_seq
        return StreamTransfer(request, prompt_tokens, nbytes_page, t0, f"{self._xfer_tag}:{n}")

    def kick(self, transfer: StreamTransfer) -> None:
        """New pages staged: wake the exporter thread to drain them."""
        self._q.put(("xfer", transfer))

    def finish(self, transfer: StreamTransfer, first_token: int, now: float) -> None:
        """Activation: the slot sampled its first token and was freed — ship
        the tail, send ``end``, settle on the ACK."""
        transfer.first_token = int(first_token)
        transfer.t_activate = now
        transfer.finished = True
        self._q.put(("xfer", transfer))

    def abort(self, transfer: StreamTransfer) -> None:
        """The slot died before activation (preemption, cancel): tear the
        wire state down without touching the request — a preempted prompt
        re-prefills and re-streams from page 0 (the importer touch-skips
        positions it already holds)."""
        transfer.failed = True
        self._q.put(("abort", transfer))

    def known_blob(self) -> bool:
        """True once the peer negotiated down to HANDOFF1: the engine skips
        mid-prefill staging (pages would only accumulate)."""
        return self._mode == "blob"

    # -- exporter thread -------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if item is None:
                break
            try:
                if isinstance(item, HandoffJob):
                    self._export(item)
                else:
                    kind, transfer = item
                    if kind == "abort":
                        self._drop(transfer)
                    else:
                        self._advance(transfer)
            except Exception as e:  # noqa: BLE001 - one bad job must not kill the thread
                if isinstance(item, HandoffJob):
                    self._fail(item, f"handoff export error: {e}")
                elif item[0] != "abort":
                    self._fail_stream(item[1], f"handoff export error: {e}")

    # -- streaming path --------------------------------------------------------

    def _advance(self, t: StreamTransfer) -> None:
        if t.failed or t.settled:
            return
        try:
            self._negotiate()
        except (OSError, HandoffClosed) as e:
            self._sever()
            self._fail_stream(t, f"handoff JOIN failed: {e}")
            return
        if self._mode == "blob":
            # negotiated down: pages accumulate on the handle and ship as
            # one HANDOFF1 frame at activation
            if t.finished:
                job = HandoffJob(t.request, t.prompt_tokens, t.first_token, list(t.staged),
                                 t.nbytes_page, t.t_activate or t.t0)
                t.settled = True  # _export settles or fails the request
                self._export(job)
            return
        try:
            self._pump(t)
        except (OSError, HandoffClosed, ValueError) as e:
            self._sever()
            self._fail_stream(t, f"handoff stream failed: {e}")

    def _pump(self, t: StreamTransfer) -> None:
        """Drain staged pages onto the streams; on the finished transfer,
        close with ``end`` and settle on the ACK."""
        req = t.request
        if req.cancelled or req.expired(time.monotonic()):
            raise HandoffClosed("request expired mid-stream")
        if not t.begun:
            meta = {"v": PROTOCOL_VERSION, "kind": "begin", "xfer": t.xfer,
                    "toks": np.asarray(t.prompt_tokens, np.int64).tolist(),
                    "nbytes_page": t.nbytes_page, "kv_dtype": engine_kv_dtype(self.engine)}
            t.sent_bytes += self._send_chunk(0, req, meta, ())
            t.begun = True
        while t.sent_pages < t.staged_pages:
            hi = min(t.sent_pages + self.chunk_pages, t.staged_pages)
            # the copies were dispatched at the chunk fold; wait for them
            # here, outside every engine lock, overlapped with the next chunk
            host = _host_pages(self.engine, t.staged[t.sent_pages:hi])
            overlap = not t.finished
            meta = {"v": PROTOCOL_VERSION, "kind": "pages", "xfer": t.xfer, "seq": t.seq,
                    "start_page": t.sent_pages, "n_pages": len(host),
                    "planes": _plane_meta(host[0])}
            parts = [_byte_view(a) for page in host for a in page]
            si = t.seq % max(1, len(self._socks))
            nbytes = self._send_chunk(si, req, meta, parts)
            t.sent_bytes += nbytes
            if overlap:
                t.overlap_bytes += nbytes
            t.sent_pages = hi
            t.seq += 1
        if not t.finished:
            return  # more chunks still prefilling; the next kick resumes
        meta = {"v": PROTOCOL_VERSION, "kind": "end", "xfer": t.xfer,
                "total_pages": t.sent_pages}
        t.sent_bytes += self._send_chunk(0, req, meta, ())
        s = self._socks[0]
        s.settimeout(self._budget(req))
        (status,) = _I32.unpack(_recv_exact(s, _I32.size))
        if status != ACK_OK:
            self._fail_stream(t, f"decode worker rejected the KV stream (status {status})")
            return
        t.settled = True
        self._settle(req, t.first_token, t.sent_pages, t.sent_bytes, t.overlap_bytes,
                     t.t_activate or t.t0)

    def _send_chunk(self, si: int, req, meta: dict, parts) -> int:
        """One bounded vectored chunk write on stream ``si``; returns the
        bytes written and prices the wire time into the perf plane as
        off-device-thread work."""
        if req is not None and req.expired(time.monotonic()):
            raise HandoffClosed("request deadline exhausted mid-stream")
        s = self._socks[si]
        bufs = chunk_parts(meta, parts)
        nbytes = sum(memoryview(b).nbytes for b in bufs)
        s.settimeout(self._budget(req))
        t_w = time.monotonic()
        sendmsg_all(s, bufs)
        dt = time.monotonic() - t_w
        self._pace(nbytes)
        with self._lock:
            if si < len(self._stream_bytes):
                self._stream_bytes[si] += nbytes
                self._stream_seconds[si] = round(self._stream_seconds[si] + dt, 6)
        plane = getattr(self.engine, "perf", None)
        if plane is not None:
            plane.note_external("handoff_stream", dt, 0.0, nbytes, time.monotonic())
        return nbytes

    def _drop(self, t: StreamTransfer) -> None:
        """Abort a dead slot's transfer: a best-effort ``abort`` chunk so the
        importer frees its reassembly session; the request is untouched."""
        if t.settled or not t.begun or self._mode != "stream" or not self._socks:
            return
        try:
            self._send_chunk(0, t.request, {"v": PROTOCOL_VERSION, "kind": "abort",
                                            "xfer": t.xfer}, ())
        except (OSError, HandoffClosed, ValueError):
            self._sever()

    def _fail_stream(self, t: StreamTransfer, why: str) -> None:
        if t.settled:
            return
        t.failed = True
        t.settled = True
        with self._lock:
            self._stats["failed"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_request_deadline_exceeded_total", 1,
                                           where="handoff")
        rt = t.request.kw.get("_rt")
        if rt is not None and t.t_activate is not None:
            rt.end("engine.handoff", error=why[:120])
        if self.logger is not None:
            self.logger.warn(f"kv handoff: {why}")
        # a transfer can die while its slot still prefills: cancel, so the
        # next chunk fold frees the slot and its pages, then complete —
        # first writer wins, so the fold's own error is a no-op
        t.request.cancel("kv handoff severed")
        t.request.complete(error=DeadlineExceeded(f"kv handoff failed: {why}"))

    # -- blob path (HANDOFF1 / negotiated down) --------------------------------

    def _export(self, job: HandoffJob) -> None:
        req = job.request
        host_pages = _host_pages(self.engine, job.payloads)
        if req.cancelled or req.expired(time.monotonic()):
            self._fail(job, "request expired before KV export began")
            return
        try:
            frame = encode_frame(job.prompt_tokens, host_pages, job.nbytes_page,
                                 kv_dtype=engine_kv_dtype(self.engine))
        except ValueError as e:
            self._fail(job, str(e))
            return
        budget = self._budget(req)
        try:
            s = self._connect()
            s.settimeout(budget)
            s.sendall(frame)
            self._pace(len(frame))
            (status,) = _I32.unpack(_recv_exact(s, _I32.size))
        except (OSError, HandoffClosed) as e:
            self._sever()
            self._fail(job, f"handoff transfer failed: {e}")
            return
        if status != ACK_OK:
            self._fail(job, f"decode worker rejected the KV frame (status {status})")
            return
        self._settle(req, job.first_token, len(host_pages), len(frame), 0, job.t0)

    # -- shared settle/fail ----------------------------------------------------

    def _settle(self, req, first_token, n_pages: int, nbytes: int, overlap_bytes: int,
                t_anchor: float) -> None:
        now = time.monotonic()
        with self._lock:
            self._stats["exported"] += 1
            self._stats["pages"] += n_pages
            self._stats["bytes"] += nbytes
            self._stats["overlap_bytes"] += overlap_bytes
            tot_b = self._stats["bytes"]
            tot_o = self._stats["overlap_bytes"]
        if self.metrics is not None:
            self.metrics.increment_counter("app_tpu_kv_handoff_pages_total", n_pages,
                                           side="export")
            self.metrics.increment_counter("app_tpu_kv_handoff_bytes_total", nbytes,
                                           side="export")
            if overlap_bytes:
                self.metrics.increment_counter("app_tpu_kv_handoff_overlap_bytes_total",
                                               overlap_bytes, side="export")
            self.metrics.set_gauge("app_tpu_kv_handoff_overlap_ratio",
                                   round(tot_o / tot_b, 4) if tot_b else 0.0)
            self.metrics.record_histogram("app_tpu_kv_handoff_seconds", now - t_anchor)
        rt = req.kw.get("_rt")
        if rt is not None:
            rt.end("engine.handoff", pages=n_pages, bytes=nbytes, overlap_bytes=overlap_bytes)
        tokenizer = getattr(self.engine, "tokenizer", None)
        tokens = [int(first_token)]
        ft = req.kw.get("_first_token_at", t_anchor)
        req.complete(result={
            "tokens": tokens,
            "text": tokenizer.decode(tokens) if tokenizer is not None else None,
            "finish_reason": "handoff",
            "ttft_s": ft - req.enqueued_at,
        })

    def _fail(self, job: HandoffJob, why: str) -> None:
        with self._lock:
            self._stats["failed"] += 1
        if self.metrics is not None:
            self.metrics.increment_counter("app_request_deadline_exceeded_total", 1,
                                           where="handoff")
        rt = job.request.kw.get("_rt")
        if rt is not None:
            rt.end("engine.handoff", error=why[:120])
        if self.logger is not None:
            self.logger.warn(f"kv handoff: {why}")
        job.request.complete(error=DeadlineExceeded(f"kv handoff failed: {why}"))

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["stream_bytes"] = list(self._stream_bytes)
            out["stream_seconds"] = list(self._stream_seconds)
        out["mode"] = self._mode or ""
        out["streams"] = len(self._socks)
        b = out["bytes"]
        out["overlap_ratio"] = round(out["overlap_bytes"] / b, 4) if b else 0.0
        return out

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)
        self._thread.join(timeout=2.0)
        self._sever()


class _ImportSession:
    """Reassembly state for one streamed transfer, shared across every
    stream connection of the exporting peer; ``done`` fires when the
    contiguous imported prefix reaches the ``end`` chunk's total (or the
    session fails)."""

    __slots__ = ("toks", "nbytes_page", "pages", "cursor", "total", "added", "bytes", "status",
                 "done", "lock")

    def __init__(self):
        self.toks = None
        self.nbytes_page = 0
        self.pages: dict[int, tuple] = {}
        self.cursor = 0
        self.total: int | None = None
        self.added = 0
        self.bytes = 0
        self.status = ACK_OK
        self.done = threading.Event()
        self.lock = threading.Lock()


class HandoffServer:
    """Decode-side import listener (tpu/handoff.py:878): accepts prefill
    workers' connections and registers shipped pages as host-tier prefix
    nodes through ``engine.handoff_import`` — refcount-free payloads the
    next prefix hit promotes and uploads through the swap-in path. Speaks
    both protocol generations; a HANDOFF2 peer's pages register
    incrementally, each newly contiguous prefix at once. Planes land in
    pinned host tensors when the engine runs on the card."""

    def __init__(self, engine, listen: str = "127.0.0.1:0", *, logger=None, metrics=None,
                 max_version: int = PROTOCOL_VERSION):
        self.engine = engine
        self.logger = logger
        self.metrics = metrics
        # max_version=1 answers every JOIN with plain ACK_OK, as a
        # pre-streaming build would (a rolling upgrade's escape hatch)
        self.max_version = int(max_version)
        self._pin = getattr(getattr(engine, "device", None), "type", None) == "cuda"
        if metrics is not None:
            _register_handoff_metrics(metrics)
        host, _, port = listen.rpartition(":")
        self.host = host or "127.0.0.1"
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((self.host, int(port)))
        self._srv.listen(8)
        self.port = self._srv.getsockname()[1]
        self._stop = threading.Event()
        self._stats = {"imported": 0, "rejected": 0, "pages": 0, "bytes": 0}
        self._lock = threading.Lock()
        self._conns: list[socket.socket] = []
        self._conn_threads: list[threading.Thread] = []
        self._sessions: dict[str, _ImportSession] = {}
        self._thread = threading.Thread(target=self._accept_loop, name="kv-handoff-server",
                                        daemon=True)
        self._thread.start()

    @property
    def addr(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        self._srv.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            th = threading.Thread(target=self._serve_conn, args=(conn,), name="kv-handoff-conn",
                                  daemon=True)
            with self._lock:
                self._conns.append(conn)
                self._conn_threads = [t for t in self._conn_threads if t.is_alive()] + [th]
            th.start()

    def _reject(self, conn: socket.socket, status: int, why: str) -> None:
        with self._lock:
            self._stats["rejected"] += 1
        if self.logger is not None:
            self.logger.warn(f"kv handoff JOIN rejected: {why}")
        conn.sendall(_I32.pack(status))

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            if _recv_exact(conn, len(_MAGIC)) != _MAGIC:
                return  # not a handoff peer; drop the connection
            (hlen,) = _I32.unpack(_recv_exact(conn, _I32.size))
            if not 0 < hlen <= _MAX_HELLO_BYTES:
                return
            hello = json.loads(_recv_exact(conn, hlen).decode("utf-8"))
            want = engine_kv_dtype(self.engine)
            got = str(hello.get("kv_dtype", ""))
            if got != want:
                self._reject(conn, ACK_DTYPE_MISMATCH,
                             f"peer kv dtype {got!r} != import pool {want!r}")
                return
            # the adapter-era gates only when the hello carries the fields
            if "adapters" in hello:
                want_ad = str(getattr(self.engine, "adapters_digest", lambda: "")())
                got_ad = str(hello.get("adapters", ""))
                if got_ad != want_ad:
                    self._reject(conn, ACK_ADAPTER_MISMATCH,
                                 f"peer adapter set {got_ad or '<none>'} != local "
                                 f"{want_ad or '<none>'} (register identical adapters on both "
                                 "P/D sides)")
                    return
            if "weights_epoch" in hello:
                want_we = int(getattr(self.engine, "weights_epoch", 0) or 0)
                got_we = int(hello.get("weights_epoch", 0) or 0)
                if got_we != want_we:
                    self._reject(conn, ACK_EPOCH_MISMATCH,
                                 f"peer base-weight epoch {got_we} != local {want_we} (hot-swap "
                                 "must land on both sides before pages move)")
                    return
            if "kv_shards" in hello:
                want_sh = int(getattr(self.engine, "kv_shards", 1) or 1)
                got_sh = int(hello.get("kv_shards", 1) or 1)
                if got_sh != want_sh:
                    self._reject(conn, ACK_SHARD_MISMATCH,
                                 f"peer pool tp degree {got_sh} != local {want_sh} "
                                 "(ENGINE_KV_SHARD / mesh tp size must agree across the P/D "
                                 "split)")
                    return
            if (int(hello.get("version", 1) or 1) >= PROTOCOL_VERSION
                    and self.max_version >= PROTOCOL_VERSION):
                conn.sendall(_I32.pack(ACK_OK_STREAM))
                self._serve_stream(conn, want)
                return
            conn.sendall(_I32.pack(ACK_OK))
            while not self._stop.is_set():
                toks, payloads, nbytes_page, frame_dtype = decode_frame(conn, self._pin)
                if frame_dtype and frame_dtype != want:
                    # JOIN said one thing, the frame another: reject the
                    # frame, keep the connection
                    conn.sendall(_I32.pack(ACK_DTYPE_MISMATCH))
                    with self._lock:
                        self._stats["rejected"] += 1
                    continue
                try:
                    added = self.engine.handoff_import(toks, payloads, nbytes_page)
                    status = ACK_OK
                except Exception as e:  # noqa: BLE001 - reject, keep serving
                    added = 0
                    status = ACK_REJECTED
                    if self.logger is not None:
                        self.logger.warn(f"kv handoff import rejected: {e}")
                nbytes = len(payloads) * nbytes_page
                with self._lock:
                    if status == ACK_OK:
                        self._stats["imported"] += 1
                        self._stats["pages"] += added
                        self._stats["bytes"] += nbytes
                    else:
                        self._stats["rejected"] += 1
                if self.metrics is not None and status == ACK_OK:
                    self.metrics.increment_counter("app_tpu_kv_handoff_pages_total", added,
                                                   side="import")
                    self.metrics.increment_counter("app_tpu_kv_handoff_bytes_total", nbytes,
                                                   side="import")
                conn.sendall(_I32.pack(status))
        except (HandoffClosed, ValueError, OSError, KeyError, json.JSONDecodeError):
            pass  # peer gone or corrupt stream: drop the connection
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)

    # -- HANDOFF2 streaming import ---------------------------------------------

    def _session(self, xfer: str) -> _ImportSession:
        with self._lock:
            sess = self._sessions.get(xfer)
            if sess is None:
                while len(self._sessions) >= _MAX_SESSIONS:
                    # oldest-first orphan drop: host payloads only
                    self._sessions.pop(next(iter(self._sessions)))
                sess = self._sessions[xfer] = _ImportSession()
            return sess

    def _ingest(self, sess: _ImportSession) -> None:
        """Advance the contiguous-prefix cursor and register every newly
        contiguous page (the incremental import; ``insert_host`` touch-skips
        positions already registered). Caller holds sess.lock."""
        if sess.toks is None or sess.status != ACK_OK:
            return
        cur = sess.cursor
        while cur in sess.pages:
            cur += 1
        if cur > sess.cursor:
            try:
                sess.added += self.engine.handoff_import(
                    sess.toks, [sess.pages[i] for i in range(cur)], sess.nbytes_page)
                sess.cursor = cur
            except Exception as e:  # noqa: BLE001 - reject the transfer, keep serving
                sess.status = ACK_REJECTED
                if self.logger is not None:
                    self.logger.warn(f"kv handoff stream import rejected: {e}")
        if sess.status != ACK_OK or (sess.total is not None and sess.cursor >= sess.total):
            sess.done.set()

    def _serve_stream(self, conn: socket.socket, want: str) -> None:
        """One stream connection's chunk loop. Sessions are shared across
        the peer's streams, so a ``pages`` chunk that races ahead of its
        transfer's ``begin`` parks until the tokens arrive."""
        while not self._stop.is_set():
            meta, payloads, nbytes = read_chunk(conn, self._pin)
            kind = str(meta.get("kind", ""))
            xfer = str(meta.get("xfer", ""))
            if kind == "begin":
                sess = self._session(xfer)
                with sess.lock:
                    sess.toks = np.asarray(meta["toks"], np.int32)
                    sess.nbytes_page = int(meta["nbytes_page"])
                    if str(meta.get("kv_dtype", "") or want) != want:
                        sess.status = ACK_DTYPE_MISMATCH
                    self._ingest(sess)
            elif kind == "pages":
                sess = self._session(xfer)
                with sess.lock:
                    start = int(meta["start_page"])
                    for j, page in enumerate(payloads):
                        sess.pages[start + j] = page
                    sess.bytes += nbytes
                    self._ingest(sess)
            elif kind == "end":
                sess = self._session(xfer)
                with sess.lock:
                    sess.total = int(meta["total_pages"])
                    self._ingest(sess)
                # other streams may still drain their chunks: bound the wait
                # by the engine's own handoff budget, then answer on THIS
                # connection (the exporter's control stream)
                ok = sess.done.wait(max(0.1, float(getattr(self.engine, "handoff_timeout_s",
                                                           5.0))))
                status = sess.status if ok else ACK_REJECTED
                with self._lock:
                    self._sessions.pop(xfer, None)
                    if status == ACK_OK:
                        self._stats["imported"] += 1
                        self._stats["pages"] += sess.added
                        self._stats["bytes"] += sess.bytes
                    else:
                        self._stats["rejected"] += 1
                if self.metrics is not None and status == ACK_OK:
                    self.metrics.increment_counter("app_tpu_kv_handoff_pages_total", sess.added,
                                                   side="import")
                    self.metrics.increment_counter("app_tpu_kv_handoff_bytes_total", sess.bytes,
                                                   side="import")
                conn.sendall(_I32.pack(status))
            elif kind == "abort":
                # the exporter's slot died: drop the reassembly state; pages
                # already registered stay, a valid refcount-free prefix
                with self._lock:
                    self._sessions.pop(xfer, None)
            else:
                raise ValueError(f"handoff: unknown chunk kind {kind!r}")

    def stats(self) -> dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def close(self) -> None:
        """Stop accepting, close every connection and join the threads."""
        self._stop.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), []
            threads, self._conn_threads = list(self._conn_threads), []
            self._sessions.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass
        self._thread.join(timeout=2.0)
        for th in threads:
            th.join(timeout=2.0)


__all__ = [
    "ACK_ADAPTER_MISMATCH", "ACK_DTYPE_MISMATCH", "ACK_EPOCH_MISMATCH", "ACK_OK",
    "ACK_OK_STREAM", "ACK_REJECTED", "ACK_SHARD_MISMATCH", "HandoffClosed", "HandoffExporter",
    "HandoffJob", "HandoffServer", "PROTOCOL_VERSION", "StreamTransfer", "chunk_parts",
    "decode_frame", "encode_frame", "engine_kv_dtype", "read_chunk",
]
