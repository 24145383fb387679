"""The port's disaggregated prefill/decode serving (gofr_tpu_torch.gpu.
handoff and the engine's roles) held against the JAX package's
(gofr_tpu/tpu/handoff.py, tests/test_handoff.py).

- The wire: the port's HANDOFF1 frames and HANDOFF2 chunks are byte for
  byte the JAX package's for f32, bf16, int8 and packed-int4 page planes,
  and each package decodes the other's; an oversized frame and a lying
  meta are refused.
- Serving: a prefill worker completes each prompt with its first token
  (``finish_reason="handoff"``) and the decode worker's tokens equal the
  JAX colocated engine's, on the dense (f32 here), int8 and int4 pools, in
  blob and in streaming mode, for a short prompt and a chunked long one
  whose pages stream while it prefills; port → port, JAX prefill → port
  decode and port prefill → JAX decode, over real loopback sockets.
- The JOIN gates answer JAX's ACK codes; a HANDOFF1-only peer negotiates
  down; a deadline sheds a 504 with ``where="handoff"``; a sever at a chunk
  boundary (a planted ``sendmsg_all`` fault or a closed socket) leaks no
  page on either side, and the pair heals.
- The roles: JAX's validation, the colocated fallback without a target,
  the decode worker's default host tier, ``ENGINE_ROLE`` / ``HANDOFF_*``
  through ``build_engine``, and role-scoped warmup counts equal JAX's.

JAX's router tests (``TestRouterRoleAwareness``, Queue A 9) and chaos
points are not mirrored. Tolerances: none — f32 greedy tokens and wire
bytes are exact. Every engine is stopped (its handoff threads joined) and
every raw socket closed in the test that made it; waits are bounded.
"""

import json
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PROMPT = [(11 * i) % 190 + 1 for i in range(20)]  # 2 full pages at page_size 8
LONG_PROMPT = [(7 * i) % 180 + 1 for i in range(40)]  # 5 pages, chunked in 8s
# chunked prefill, one page a chunk and a wire chunk: each fold stages and
# ships a page while the next chunk is on the device
STREAM_KW = dict(prefill_buckets=[8], handoff_chunk_pages=1, total_pages=32, max_len=128)
POOLS = {"dense": "", "int8": "int8", "int4": "int4"}


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


def _kw(kw):
    out = dict(slots=4, max_len=64, max_prefill_batch=2, kv_layout="paged", page_size=8,
               total_pages=16)
    out.update(kw)
    return out


def _engine(pkg, tiny, **kw):
    if pkg == "jax":
        from gofr_tpu.container import new_mock_container
        from gofr_tpu.models import llama
        from gofr_tpu.tpu.engine import GenerateEngine

        return GenerateEngine(llama, tiny[0], tiny[1], new_mock_container(), **_kw(kw))
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    return GenerateEngine(tiny[2], device="cpu", container=new_mock_container(), **_kw(kw))


def _audit(eng, slots_empty=False):
    """The pool audit of either package."""
    if hasattr(eng, "check_page_refs"):
        eng.check_page_refs()
        if slots_empty:
            assert all(s is None for s in eng.slots)
    else:
        from gofr_tpu.testutil import assert_page_refs_consistent, assert_paged_pool_consistent

        assert_page_refs_consistent(eng)
        if slots_empty:
            assert_paged_pool_consistent(eng, slots_empty=True)


def _counter(eng, name, **labels):
    m = eng.metrics.get(name)
    if m is None:
        return 0
    return sum(v for ls, v in m._values.items() if labels.items() <= dict(ls).items())


def _pair(tiny, pre_pkg="torch", dec_pkg="torch", pre_kw=None, dec_kw=None, **kw):
    dec = _engine(dec_pkg, tiny, role="decode", **{**kw, **(dec_kw or {})})
    try:
        pre = _engine(pre_pkg, tiny, role="prefill", handoff_target=dec.handoff_addr,
                      **{**kw, **(pre_kw or {})})
    except BaseException:
        dec.stop()
        raise
    return pre, dec


_WANT: dict = {}


def _colocated(tiny, prompt, n_new, **kw):
    """The JAX colocated engine's greedy tokens (cached per config)."""
    key = (tuple(prompt), n_new, repr(sorted(kw.items())))
    if key not in _WANT:
        colo = _engine("jax", tiny, **kw)
        try:
            _WANT[key] = colo.generate(prompt, max_new_tokens=n_new, timeout=300)["tokens"]
        finally:
            colo.stop()
    return _WANT[key]


def _jax_errors():
    from gofr_tpu.http.errors import DeadlineExceeded

    return DeadlineExceeded


# -- the wire ------------------------------------------------------------------------


def _page_planes(pool: str, seed: int, layers=2, heads=2, page=8, dim=16):
    """One page's planes of a pool format, as JAX's numpy arrays (bf16 via
    ml_dtypes) and as the port's torch tensors with the same bytes."""
    import ml_dtypes

    rng = np.random.RandomState(seed)
    shape, scale_shape = (layers, heads, page, dim), (layers, heads, page)
    if pool == "f32":
        arrs = [rng.randn(*shape).astype(np.float32) for _ in range(2)]
    elif pool == "bf16":
        arrs = [rng.randn(*shape).astype(ml_dtypes.bfloat16) for _ in range(2)]
    elif pool == "int8":
        arrs = [rng.randint(-127, 128, shape).astype(np.int8) for _ in range(2)]
    else:  # packed int4 rows
        arrs = [rng.randint(0, 256, shape[:-1] + (dim // 2,)).astype(np.uint8) for _ in range(2)]
    if pool in ("int8", "int4"):
        arrs += [rng.rand(*scale_shape).astype(ml_dtypes.bfloat16) for _ in range(2)]
    tensors = []
    for a in arrs:
        if a.dtype == ml_dtypes.bfloat16:
            tensors.append(torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16))
        else:
            tensors.append(torch.from_numpy(a.copy()))
    return tuple(arrs), tuple(tensors)


def _as_numpy(t):
    import ml_dtypes

    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _through(frame: bytes, decode, **kw):
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        return decode(b, **kw)
    finally:
        a.close()
        b.close()


@pytest.mark.quick
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "int4"])
def test_frames_and_chunks_are_the_jax_wire_and_each_side_reads_the_other(pool):
    """Byte-identical HANDOFF1 frames and HANDOFF2 ``pages`` chunks for the
    same pages; JAX's ``decode_frame`` / ``read_chunk`` read the port's
    bytes and the port's read JAX's, planes bit for bit, dtypes kept."""
    from gofr_tpu.tpu import handoff as jh
    from gofr_tpu_torch.gpu import handoff as th

    pages = [_page_planes(pool, seed) for seed in range(3)]
    jpages, tpages = [p[0] for p in pages], [p[1] for p in pages]
    toks = np.arange(1, 25, dtype=np.int32)
    jframe = jh.encode_frame(toks, jpages, 4096, kv_dtype=pool)
    tframe = th.encode_frame(toks, tpages, 4096, kv_dtype=pool)
    assert tframe == jframe
    meta = {"v": 2, "kind": "pages", "xfer": "x:1", "seq": 0, "start_page": 0, "n_pages": 3,
            "planes": [{"dtype": str(a.dtype), "shape": list(a.shape)} for a in jpages[0]]}
    jchunk = b"".join(bytes(b) for b in jh.chunk_parts(
        meta, [jh._byte_view(a) for page in jpages for a in page]))
    tchunk = b"".join(bytes(b) for b in th.chunk_parts(
        meta, [th._byte_view(t) for page in tpages for t in page]))
    assert tchunk == jchunk
    # the port reads JAX's bytes, JAX reads the port's
    t_toks, t_pages, t_nb, t_dt = _through(jframe, th.decode_frame)
    j_toks, j_pages, j_nb, j_dt = _through(tframe, jh.decode_frame)
    assert t_toks.tolist() == j_toks.tolist() == toks.tolist()
    assert (t_nb, t_dt) == (j_nb, j_dt) == (4096, pool)
    for want, got_t, got_j in zip(jpages, t_pages, j_pages):
        for w, t, j in zip(want, got_t, got_j):
            assert _as_numpy(t).dtype == j.dtype == w.dtype
            assert _as_numpy(t).tobytes() == j.tobytes() == w.tobytes()
    t_meta, t_chunk_pages, t_n = _through(jchunk, th.read_chunk)
    j_meta, j_chunk_pages, j_n = _through(tchunk, jh.read_chunk)
    assert t_meta == j_meta == meta and t_n == j_n
    assert [[_as_numpy(t).tobytes() for t in p] for p in t_chunk_pages] == [
        [a.tobytes() for a in p] for p in j_chunk_pages]


@pytest.mark.quick
def test_the_codec_refuses_an_oversized_frame_and_a_lying_meta(monkeypatch):
    """JAX's caps: encode refuses past ``MAX_FRAME_BYTES``; a meta that
    advertises more than the cap, or an unknown plane dtype, is a corrupt
    stream, refused before any payload is read."""
    from gofr_tpu_torch.gpu import handoff as th

    big = [(torch.zeros(64, dtype=torch.float32),)]
    monkeypatch.setattr(th, "MAX_FRAME_BYTES", 64)
    with pytest.raises(ValueError, match="refusing to send"):
        th.encode_frame(np.asarray([1], np.int32), big, 256)
    monkeypatch.undo()
    for planes, n_pages in (([{"dtype": "float32", "shape": [1024, 1024]}], 1 << 30),
                            ([{"dtype": "complex64", "shape": [4]}], 1)):
        meta = json.dumps({"toks": [1], "n_pages": n_pages, "nbytes_page": 4,
                           "planes": planes}).encode()
        with pytest.raises(ValueError, match="corrupt stream|unknown plane dtype"):
            _through(struct.pack("<i", len(meta)) + meta, th.decode_frame)
    with pytest.raises(ValueError, match="corrupt stream"):
        _through(struct.pack("<i", -5), th.read_chunk)


# -- serving: token-exact against the JAX colocated engine ---------------------------------------


PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


@pytest.mark.quick
@pytest.mark.parametrize("pre_pkg,dec_pkg", PAIRS, ids=["port_port", "jax_port", "port_jax"])
@pytest.mark.parametrize("pool", list(POOLS))
@pytest.mark.parametrize("streams", [2, 0], ids=["stream", "blob"])
@pytest.mark.parametrize("long", [False, True], ids=["short", "chunked"])
def test_disaggregated_tokens_equal_the_jax_colocated_engine(tiny, pre_pkg, dec_pkg, pool,
                                                             streams, long):
    """The prefill worker ends the request with the colocated first token
    and ``finish_reason="handoff"``; the decode worker holds every full page
    in its host tier, swaps them in and decodes the colocated tokens; the
    export counts the pages; both pools pass their audit with every slot
    empty. A chunked prompt stages a page at each chunk fold (whether the
    exporter ships it before the last fold is a race of threads, held at
    the exporter's API below)."""
    kw = dict(kv_quantize=POOLS[pool], **(STREAM_KW if long else {}))
    prompt, n_new = (LONG_PROMPT, 5) if long else (PROMPT, 6)
    n_pages = len(prompt) // 8
    want = _colocated(tiny, prompt, n_new, **{k: v for k, v in kw.items()
                                               if k != "handoff_chunk_pages"})
    pre, dec = _pair(tiny, pre_pkg, dec_pkg, pre_kw=dict(handoff_streams=streams), **kw)
    kicks = []
    if pre_pkg == "torch":
        kick = pre._handoff_exporter.kick
        pre._handoff_exporter.kick = lambda t: (kicks.append(t.staged_pages), kick(t))
    try:
        res = pre.generate(prompt, max_new_tokens=n_new, timeout=300)
        if pre_pkg == "torch":
            # streaming stages each page at the fold that completes it
            assert kicks == ([1, 2, 3, 4] if long and streams else [])
        assert res["finish_reason"] == "handoff" and res["tokens"] == [want[0]]
        assert res["ttft_s"] >= 0
        st = pre._handoff_exporter.stats()
        assert st["exported"] == 1 and st["pages"] == n_pages and st["failed"] == 0
        assert st["mode"] == ("stream" if streams else "blob")
        assert dec._prefix.host_pages == n_pages
        assert dec._handoff_server.stats()["imported"] == 1
        out = dec.generate(prompt, max_new_tokens=n_new, timeout=300)
        assert out["tokens"] == want
        assert _counter(dec, "app_tpu_prefix_swapin_pages_total") == n_pages - (
            1 if len(prompt) % 8 == 0 else 0)
        assert _counter(pre, "app_tpu_kv_handoff_pages_total", side="export") == n_pages
        _audit(pre)
        _audit(dec, slots_empty=True)
    finally:
        pre.stop()
        dec.stop()


@pytest.mark.quick
def test_handoff_stats_span_and_metrics(tiny):
    """``handoff_stats`` (role, export and import counters, the decode
    address), the export-side transfer metrics, and an ``engine.handoff``
    span between the request's decode and its end."""
    from gofr_tpu_torch.tracing import MemoryExporter, Tracer

    pre, dec = _pair(tiny)
    try:
        pre.tracer = Tracer(MemoryExporter())
        pre.generate(PROMPT, max_new_tokens=4, timeout=300)
        ps, ds = pre.handoff_stats(), dec.handoff_stats()
        assert ps["role"] == "prefill" and ps["export"]["exported"] == 1
        assert ds["role"] == "decode" and ds["import"]["imported"] == 1
        assert ds["addr"] == dec.handoff_addr
        lat = pre.metrics.get("app_tpu_kv_handoff_seconds")
        assert lat is not None and lat.count() == 1
        assert _counter(pre, "app_tpu_kv_handoff_bytes_total", side="export") == ps["export"][
            "bytes"]
        assert _counter(dec, "app_tpu_kv_handoff_pages_total", side="import") == 2
        pre.tracer.shutdown()
        names = [s.name for s in pre.tracer._exporter.spans]
        assert "engine.handoff" in names and names.index("engine.prefill") < names.index(
            "engine.handoff")
        colo = _engine("torch", tiny)
        try:
            assert colo.handoff_stats() == {"role": "both"}
        finally:
            colo.stop()
    finally:
        pre.stop()
        dec.stop()


# -- the JOIN gates ------------------------------------------------------------------


def _raw_join(addr, hello: dict) -> int:
    """Dial a decode worker, send magic + hello, return its ACK."""
    from gofr_tpu_torch.gpu import handoff as th

    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5.0)
    try:
        body = json.dumps(hello).encode()
        s.sendall(th._MAGIC + th._I32.pack(len(body)) + body)
        return th._I32.unpack(th._recv_exact(s, 4))[0]
    finally:
        s.close()


@pytest.mark.quick
@pytest.mark.parametrize("dec_pkg", ["torch", "jax"])
def test_join_gates_answer_jax_s_ack_codes(tiny, dec_pkg):
    """The same hellos against a port and a JAX decode worker: the same
    ACK codes (dtype 2, adapters 3, epoch 4, tp degree 6, a v2 hello 5, a
    v1 or pre-adapter hello 0), each rejection counted."""
    dec = _engine(dec_pkg, tiny, role="decode")
    try:
        base = {"kv_dtype": "bf16"}
        codes = [_raw_join(dec.handoff_addr, h) for h in (
            {"kv_dtype": "int4"}, {**base, "adapters": "abc"}, {**base, "weights_epoch": 3},
            {**base, "kv_shards": 2}, {**base, "version": 2, "streams": 2}, base,
            {**base, "adapters": "", "weights_epoch": 0, "kv_shards": 1})]
        assert codes == [2, 3, 4, 6, 5, 0, 0]
        assert dec._handoff_server.stats()["rejected"] == 4
    finally:
        dec.stop()


@pytest.mark.quick
@pytest.mark.parametrize("dec_pkg", ["torch", "jax"])
def test_a_pre_adapter_hello_is_a_wildcard(tiny, dec_pkg):
    """A hello without the adapter, epoch and tp fields (a peer from
    before those gates) joins a decode worker that has adapters loaded and
    an adoption behind it: the gates it does not name are wildcards."""
    dec = _engine(dec_pkg, tiny, role="decode", adapter_slots=2, adapter_rank=8)
    try:
        if dec_pkg == "jax":
            from gofr_tpu.adapters import random_adapter
        else:
            from gofr_tpu_torch.adapters import random_adapter
        dec.register_adapter(random_adapter("fr", 64, 256, rank=4, seed=1))
        dec.adopt_weights(tiny[2] if dec_pkg == "torch" else tiny[1])
        assert _raw_join(dec.handoff_addr, {"kv_dtype": "bf16"}) == 0
        assert dec._handoff_server.stats()["rejected"] == 0
    finally:
        dec.stop()


@pytest.mark.quick
@pytest.mark.parametrize("gate", ["kv_dtype", "adapters", "weights_epoch"])
@pytest.mark.parametrize("pre_pkg,dec_pkg", PAIRS, ids=["port_port", "jax_port", "port_jax"])
def test_a_join_mismatch_sheds_the_request_and_leaks_nothing(tiny, gate, pre_pkg, dec_pkg):
    """A prefill worker whose pool dtype, adapter set or weights epoch
    differs from the decode worker's is rejected at JOIN: the request ends
    504 (where="handoff" counted), nothing is imported, both pools audit
    clean, and the decode worker logs which gate it was."""
    pre_kw, dec_kw = {"handoff_timeout_s": 1.0}, {}
    if gate == "kv_dtype":
        pre_kw["kv_quantize"] = "int4"
    elif gate == "adapters":
        pre_kw.update(adapter_slots=2, adapter_rank=8)
        dec_kw.update(adapter_slots=2, adapter_rank=8)
    pre, dec = _pair(tiny, pre_pkg, dec_pkg, pre_kw=pre_kw, dec_kw=dec_kw)
    try:
        if gate == "adapters":
            if dec_pkg == "jax":
                from gofr_tpu.adapters import random_adapter
            else:
                from gofr_tpu_torch.adapters import random_adapter
            dec.register_adapter(random_adapter("fr", 64, 256, rank=4, seed=1))
            assert pre.adapters_digest() != dec.adapters_digest()
        if gate == "weights_epoch":
            dec.adopt_weights(tiny[2] if dec_pkg == "torch" else tiny[1])
        errors = (_jax_errors(),) if pre_pkg == "jax" else ()
        from gofr_tpu_torch.http.errors import DeadlineExceeded

        with pytest.raises((DeadlineExceeded, *errors), match="handoff"):
            pre.generate(PROMPT, max_new_tokens=4, timeout=300)
        assert pre._handoff_exporter.stats()["failed"] == 1
        assert _counter(pre, "app_request_deadline_exceeded_total", where="handoff") == 1
        assert dec._handoff_server.stats()["imported"] == 0
        assert dec._handoff_server.stats()["rejected"] >= 1
        assert dec._prefix.host_pages == 0
        hint = {"kv_dtype": "kv dtype", "adapters": "adapter set",
                "weights_epoch": "base-weight epoch"}[gate]
        assert any(hint in ln for ln in dec.container.logger.lines)
        _audit(pre)
        _audit(dec)
    finally:
        pre.stop()
        dec.stop()


@pytest.mark.quick
def test_epoch_realignment_restores_the_path(tiny):
    """Once the same adoption lands on the prefill side too, pages move."""
    pre, dec = _pair(tiny)
    try:
        dec.adopt_weights(tiny[2])
        pre.adopt_weights(tiny[2])
        res = pre.generate(PROMPT, max_new_tokens=4, timeout=300)
        assert res["finish_reason"] == "handoff"
        assert dec._handoff_server.stats()["imported"] == 1
    finally:
        pre.stop()
        dec.stop()


@pytest.mark.quick
@pytest.mark.parametrize("pre_pkg,dec_pkg", PAIRS, ids=["port_port", "jax_port", "port_jax"])
def test_a_handoff1_only_peer_negotiates_down_token_exact(tiny, pre_pkg, dec_pkg):
    """A streaming exporter against a server capped at version 1 ships one
    blob frame (no overlap); a blob-configured exporter against a v2 server
    joins as blob. Both pairs serve the colocated tokens."""
    want = _colocated(tiny, PROMPT, 5)
    for cap, streams in ((1, 2), (2, 0)):
        pre, dec = _pair(tiny, pre_pkg, dec_pkg, pre_kw=dict(handoff_streams=streams))
        try:
            dec._handoff_server.max_version = cap
            res = pre.generate(PROMPT, max_new_tokens=5, timeout=300)
            assert res["finish_reason"] == "handoff" and res["tokens"] == [want[0]]
            st = pre._handoff_exporter.stats()
            assert st["mode"] == "blob" and st["overlap_bytes"] == 0
            assert dec._prefix.host_pages == 2
            assert dec.generate(PROMPT, max_new_tokens=5, timeout=300)["tokens"] == want
        finally:
            pre.stop()
            dec.stop()


# -- streaming internals -------------------------------------------------------------


def _dial_v2(addr):
    from gofr_tpu_torch.gpu import handoff as th

    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=5.0)
    hello = json.dumps({"kv_dtype": "bf16", "version": 2, "streams": 2}).encode()
    s.sendall(th._MAGIC + th._I32.pack(len(hello)) + hello)
    assert th._I32.unpack(th._recv_exact(s, 4))[0] == th.ACK_OK_STREAM
    return s


def _pool_page(dec, fill):
    from gofr_tpu_torch.ops.paged import page_planes

    return tuple(torch.full((p.shape[0], *p.shape[2:]), fill, dtype=p.dtype)
                 for p in page_planes(dec.cache))


@pytest.mark.quick
def test_out_of_order_chunks_reassemble_across_streams(tiny):
    """Page 1 arrives on stream B before ``begin`` and page 0 on stream A:
    it parks until the tokens and page 0 arrive, then the contiguous
    prefix registers and ``end`` is ACKed with both pages imported."""
    from gofr_tpu_torch.gpu import handoff as th

    dec = _engine("torch", tiny, role="decode")
    s0 = s1 = None
    try:
        s0, s1 = _dial_v2(dec.handoff_addr), _dial_v2(dec.handoff_addr)
        pages = [_pool_page(dec, 0.125), _pool_page(dec, 0.375)]
        planes = th._plane_meta(pages[0])

        def send(sock, meta, payload=()):
            parts = [th._byte_view(t) for page in payload for t in page]
            sock.sendall(b"".join(bytes(b) for b in th.chunk_parts(meta, parts)))

        send(s1, {"v": 2, "kind": "pages", "xfer": "t:1", "seq": 1, "start_page": 1,
                  "n_pages": 1, "planes": planes}, [pages[1]])
        time.sleep(0.1)
        assert dec._prefix.host_pages == 0
        send(s0, {"v": 2, "kind": "begin", "xfer": "t:1", "toks": PROMPT,
                  "nbytes_page": dec._page_bytes, "kv_dtype": "bf16"})
        send(s0, {"v": 2, "kind": "pages", "xfer": "t:1", "seq": 0, "start_page": 0,
                  "n_pages": 1, "planes": planes}, [pages[0]])
        send(s0, {"v": 2, "kind": "end", "xfer": "t:1", "total_pages": 2})
        s0.settimeout(10.0)
        assert th._I32.unpack(th._recv_exact(s0, 4))[0] == th.ACK_OK
        assert dec._prefix.host_pages == 2
        st = dec._handoff_server.stats()
        assert st["imported"] == 1 and st["pages"] == 2
        _audit(dec)
    finally:
        for s in (s0, s1):
            if s is not None:
                s.close()
        dec.stop()


@pytest.mark.quick
def test_overlap_is_counted_at_the_exporter_api(tiny):
    """Pages staged and shipped before ``finish`` count as overlap bytes,
    the tail after it does not; the first page is imported before the
    transfer ends; counter and gauge land in the registry."""
    from gofr_tpu_torch.gpu import handoff as th
    from gofr_tpu_torch.gpu.engine import Request
    from gofr_tpu_torch.gpu.executor import Readback
    from gofr_tpu_torch.metrics import Registry

    def staged(fill):
        return Readback(torch.device("cpu"), *_pool_page(dec, fill), timed=True)

    dec = _engine("torch", tiny, role="decode")
    exp = None
    try:
        metrics = Registry()
        exp = th.HandoffExporter(dec.handoff_addr, engine=None, timeout_s=5.0, streams=2,
                                 chunk_pages=1, metrics=metrics)
        req = Request(list(PROMPT), {}, timeout=30.0)
        t = exp.begin_stream(req, np.asarray(PROMPT), dec._page_bytes, time.monotonic())
        t.add([staged(0.25)])
        exp.kick(t)
        deadline = time.monotonic() + 5.0
        while dec._prefix.host_pages < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert t.sent_pages == 1 and dec._prefix.host_pages == 1
        t.add([staged(0.5)])
        exp.finish(t, first_token=3, now=time.monotonic())
        res = req.result(timeout=10.0)
        assert res["finish_reason"] == "handoff" and res["tokens"] == [3]
        st = exp.stats()
        assert st["exported"] == 1 and st["pages"] == 2
        assert 0 < st["overlap_bytes"] < st["bytes"] and 0 < st["overlap_ratio"] < 1
        ovl = metrics.get("app_tpu_kv_handoff_overlap_bytes_total")
        assert sum(ovl._values.values()) == st["overlap_bytes"]
        assert dec._prefix.host_pages == 2
    finally:
        if exp is not None:
            exp.close()
        dec.stop()


# -- failures: deadlines and severs --------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("stream", [False, True], ids=["blob_never_accepted", "stream_stalls"])
def test_a_stuck_transfer_sheds_504_within_its_budget(tiny, stream):
    """A listener that never accepts (blob), or one that ACKs the streaming
    JOIN and then never ACKs ``end``: the request ends 504 within the
    handoff budget, ``where="handoff"`` is counted, and the prefill pool
    audits clean."""
    from gofr_tpu_torch.gpu import handoff as th
    from gofr_tpu_torch.http.errors import DeadlineExceeded

    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    conns, stop, acceptor = [], threading.Event(), None
    if stream:
        srv.settimeout(0.1)

        def ack_then_stall():
            while not stop.is_set():
                try:
                    conn, _ = srv.accept()
                except OSError:
                    continue
                conns.append(conn)
                th._recv_exact(conn, len(th._MAGIC))
                (n,) = th._I32.unpack(th._recv_exact(conn, 4))
                th._recv_exact(conn, n)
                conn.sendall(th._I32.pack(th.ACK_OK_STREAM))

        acceptor = threading.Thread(target=ack_then_stall, daemon=True)
        acceptor.start()
    kw = dict(STREAM_KW) if stream else {"handoff_streams": 0}
    eng = _engine("torch", tiny, role="prefill", handoff_timeout_s=0.5,
                  handoff_target=f"127.0.0.1:{srv.getsockname()[1]}", **kw)
    try:
        t0 = time.monotonic()
        with pytest.raises(DeadlineExceeded, match="handoff"):
            eng.generate(LONG_PROMPT if stream else PROMPT, max_new_tokens=4, timeout=300)
        assert time.monotonic() - t0 < 10.0
        assert _counter(eng, "app_request_deadline_exceeded_total", where="handoff") == 1
        assert eng._handoff_exporter.stats()["failed"] == 1
        deadline = time.monotonic() + 10
        while any(s is not None for s in eng.slots) and time.monotonic() < deadline:
            time.sleep(0.01)
        _audit(eng, slots_empty=True)
    finally:
        eng.stop()
        stop.set()
        if acceptor is not None:
            acceptor.join(5.0)
        for c in conns:
            c.close()
        srv.close()


def _planted(real, how: str, nth: int):
    """A ``sendmsg_all`` that fails on its ``nth`` ``pages`` chunk: before
    writing it (a sever at the chunk boundary), after writing only its
    header (a torn chunk), or after closing the socket under it."""
    seen = [0]

    def send(sock, bufs):
        bufs = list(bufs)
        if b'"kind": "pages"' in bytes(bufs[1]):
            seen[0] += 1
            if seen[0] == nth:
                from gofr_tpu_torch.gpu.handoff import HandoffClosed

                if how == "torn":
                    real(sock, bufs[:1])
                    raise HandoffClosed("planted: torn chunk")
                if how == "closed":
                    sock.close()
                    return real(sock, bufs)
                raise HandoffClosed("planted: sever at a chunk boundary")
        return real(sock, bufs)

    return send


@pytest.mark.quick
@pytest.mark.parametrize("how,nth", [("boundary", 1), ("boundary", 3), ("torn", 2),
                                     ("closed", 2)])
def test_a_sever_at_a_chunk_boundary_leaks_nothing_and_heals(tiny, monkeypatch, how, nth):
    """A streamed transfer severed at its ``nth`` page chunk ends 504; the
    pages imported before it are a valid shorter host prefix (no transfer
    counts as imported); both pools audit clean with every slot empty, and
    once the fault is gone the exporter re-dials and the same prompt ships
    whole."""
    from gofr_tpu_torch.gpu import handoff as th
    from gofr_tpu_torch.http.errors import DeadlineExceeded

    pre, dec = _pair(tiny, **STREAM_KW)
    try:
        monkeypatch.setattr(th, "sendmsg_all", _planted(th.sendmsg_all, how, nth))
        with pytest.raises(DeadlineExceeded, match="handoff"):
            pre.generate(LONG_PROMPT, max_new_tokens=4, timeout=300)
        monkeypatch.undo()
        assert dec._handoff_server.stats()["imported"] == 0
        assert dec._prefix.host_pages < 5
        deadline = time.monotonic() + 10
        while any(s is not None for s in pre.slots) and time.monotonic() < deadline:
            time.sleep(0.01)
        _audit(pre, slots_empty=True)
        _audit(dec, slots_empty=True)
        res = pre.generate(LONG_PROMPT, max_new_tokens=4, timeout=300)
        assert res["finish_reason"] == "handoff"
        assert dec._prefix.host_pages == 5
        _audit(pre)
        _audit(dec)
    finally:
        pre.stop()
        dec.stop()


# -- the roles -----------------------------------------------------------------------


@pytest.mark.quick
def test_role_validation_raises_jax_s_messages(tiny):
    """A role on the slot layout, an unknown role, a decode worker without
    the prefix cache: the same ValueError messages as the JAX engine."""
    cases = (dict(kv_layout="slot", role="prefill", page_size=None, total_pages=None),
             dict(role="sidecar"), dict(role="decode", prefix_cache=False))
    for kw in cases:
        msgs = []
        for pkg in ("jax", "torch"):
            with pytest.raises(ValueError) as e:
                _engine(pkg, tiny, **kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


@pytest.mark.quick
def test_prefill_without_a_target_serves_colocated_and_decode_defaults_its_host_tier(tiny):
    """A prefill worker without ``handoff_target`` warns and decodes
    locally (the colocated tokens); a decode worker's host tier defaults to
    max(one page, 256 MiB), as JAX's; a prompt shorter than a page on a
    wired prefill worker serves colocated too."""
    want = _colocated(tiny, PROMPT, 4)
    eng = _engine("torch", tiny, role="prefill")
    try:
        res = eng.generate(PROMPT, max_new_tokens=4, timeout=300)
        assert res["finish_reason"] == "length" and res["tokens"] == want
        assert any("without HANDOFF_TARGET" in ln for ln in eng.container.logger.lines)
    finally:
        eng.stop()
    budgets = []
    for pkg in ("jax", "torch"):
        dec = _engine(pkg, tiny, role="decode")
        try:
            budgets.append(dec._prefix.host_budget)
        finally:
            dec.stop()
    assert budgets[0] == budgets[1] == 256 << 20
    pre, dec = _pair(tiny)
    try:
        short = PROMPT[:7]
        res = pre.generate(short, max_new_tokens=4, timeout=300)
        assert res["finish_reason"] == "length"
        assert res["tokens"] == _colocated(tiny, short, 4)
        assert pre._handoff_exporter.stats()["exported"] == 0
        _audit(pre, slots_empty=True)
    finally:
        pre.stop()
        dec.stop()


@pytest.mark.quick
def test_engine_role_and_handoff_keys_through_build_engine_equal_jax(tiny):
    """``ENGINE_ROLE`` and the ``HANDOFF_*`` keys reach the engine as the
    JAX ``build_engine`` reads them, and a config-built pair serves."""
    import jax.numpy as jnp
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import LlamaConfig as JaxConfig
    from gofr_tpu.models import ModelSpec as JaxSpec
    from gofr_tpu.tpu.engine import build_engine as jax_build
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    kw = dict(seed=7, slots=4, max_len=64, page_size=8)
    dec_env = {"ENGINE_ROLE": "decode", "HANDOFF_TIMEOUT_S": "2.5",
               "ENGINE_PREFIX_HOST_MB": "4"}

    def knobs(e):
        return {"role": e.role, "timeout": e.handoff_timeout_s, "streams": e.handoff_streams,
                "chunk": e.handoff_chunk_pages, "pace": e.handoff_pace_mbps,
                "host": e._prefix.host_budget, "wired": e._handoff_exporter is not None}

    jdec = jax_build(JaxSpec("llama", JaxConfig.tiny(), dtype=jnp.float32),
                     jax_container(dec_env), kv_layout="paged", **kw)
    params = jax.tree.map(np.asarray, jdec.params)
    spec = ModelSpec("llama", LlamaConfig.tiny(), weights=params, dtype=torch.float32)
    dec = build_engine(spec, new_mock_container(dec_env), device="cpu", **kw)
    pre_env = {"ENGINE_ROLE": "prefill", "HANDOFF_TARGET": dec.handoff_addr,
               "HANDOFF_STREAMS": "3", "HANDOFF_CHUNK_PAGES": "2", "HANDOFF_PACE_MBPS": "0"}
    jpre = pre = None
    try:
        jpre = jax_build(JaxSpec("llama", JaxConfig.tiny(), dtype=jnp.float32),
                         jax_container(pre_env), kv_layout="paged", **kw)
        pre = build_engine(spec, new_mock_container(pre_env), device="cpu", **kw)
        assert knobs(dec) == knobs(jdec) and knobs(pre) == knobs(jpre)
        assert dec.handoff_addr and dec.role == "decode" and pre.role == "prefill"
        res = pre.generate(PROMPT, max_new_tokens=3, timeout=300)
        assert res["finish_reason"] == "handoff"
        assert dec.generate(PROMPT, max_new_tokens=3, timeout=300)["tokens"][0] == res["tokens"][0]
    finally:
        for e in (pre, jpre, dec, jdec):
            if e is not None:
                e.stop()


@pytest.mark.quick
@pytest.mark.parametrize("role", ["prefill", "decode", "both"])
def test_role_scoped_warmup_counts_equal_jax(tiny, role):
    """A prefill worker skips the decode chunk and warms the page gather,
    a decode worker skips the batched-prefill ladder: the port's warmup
    runs as many calls as JAX's compiles, and the pools stay consistent."""
    counts = []
    for pkg in ("jax", "torch"):
        eng = _engine(pkg, tiny, role=role, prefill_buckets=[8, 16])
        try:
            counts.append(eng.warmup())
            _audit(eng, slots_empty=True)
        finally:
            eng.stop()
    assert counts[0] == counts[1]
