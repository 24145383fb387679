"""The port's split-plan autotuner (gofr_tpu_torch/ops/autotune.py) held
against the JAX tuner (gofr_tpu/ops/autotune.py), and its engine seam.

The tuners run on the same fake timings (no kernel is timed): the same
decisions, records, cache hits, role keys and handling of stale or
corrupt files, the candidates named by the port's plans where JAX's are
``xla`` / ``pallas``. The engine seam runs on the CPU with ``enabled``
patched, a fake timer and an injected candidate launcher, the split
plain version at each plan. Tolerances: the split plain version at every
candidate plan equals the unsplit plain version within 1e-5 (f32: the
split changes only the order of the sums).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

JAX_NAMES = ("xla", "pallas")
PORT_NAMES = ("rows192", "rows64")


def _fake_timer(seconds):
    it = iter(seconds)

    def timer(fn):
        return next(it)

    return timer


def _tuners(tmp_path=None, timings=None, **kw):
    """(JAX tuner, port tuner) with the same arguments, each with its own
    fake timer over ``timings`` when given; each writes its own cache file
    under ``tmp_path``."""
    from gofr_tpu.ops import autotune as jat
    from gofr_tpu_torch.ops import autotune as pat

    out = []
    for mod, name in ((jat, "jax.json"), (pat, "port.json")):
        cache = str(tmp_path / name) if tmp_path is not None else None
        if timings is not None:
            kw["timer"] = _fake_timer(timings)
        out.append(mod.Autotuner(device_kind="H100", cache_file=cache, **kw))
    return out


def _cands(names):
    return {n: (lambda: None) for n in names}


def _neutral(rec, names):
    """A decision record with the candidate names replaced by their index."""
    idx = {n: i for i, n in enumerate(names)}
    out = dict(rec)
    out["backend"] = idx[rec["backend"]]
    out["timings_ms"] = {idx[n]: v for n, v in rec.get("timings_ms", {}).items()}
    if "errors" in rec:
        out["errors"] = sorted(idx[n] for n in rec["errors"])
    return out


@pytest.mark.quick
@pytest.mark.parametrize("timings", [[3e-3, 1e-3], [1e-3, 3e-3], [2e-3, 2e-3]])
def test_the_same_timings_make_the_same_decision(timings):
    """The faster candidate wins, the first on a tie (the rule's plan
    comes first in the port), with the same record."""
    jt, pt = _tuners(timings=timings)
    jw = jt.measure("paged_decode", "8x16", "bf16", _cands(JAX_NAMES))
    pw = pt.measure("paged_decode", "8x16", "bf16", _cands(PORT_NAMES))
    assert JAX_NAMES.index(jw) == PORT_NAMES.index(pw)
    assert (_neutral(jt.decisions["paged_decode"], JAX_NAMES)
            == _neutral(pt.decisions["paged_decode"], PORT_NAMES))
    assert pt.pins() == {"paged_decode": pw}
    assert pt.shapes() == {"paged_decode": "8x16"}


@pytest.mark.quick
def test_only_candidate_is_pinned_untimed():
    def no_timer(fn):
        raise AssertionError("timed a single candidate")

    jt, pt = _tuners(timer=no_timer)
    assert jt.measure("decode", "4x97", "float32", _cands(["xla"])) == "xla"
    assert pt.measure("decode", "4x97", "float32", _cands(["rows128"])) == "rows128"
    assert (_neutral(jt.decisions["decode"], ["xla"])
            == _neutral(pt.decisions["decode"], ["rows128"]))
    assert pt.decisions["decode"]["source"] == "only_candidate"


@pytest.mark.quick
def test_a_failing_candidate_loses_and_all_failing_raises():
    """A disqualified candidate is recorded under ``errors`` and loses, as
    a failing one does in JAX; where every candidate fails JAX pins
    ``xla`` and the port, which has no second backend, raises (the rule's
    plan, the first, failing is enough). Any other error a candidate
    raises is no disqualification: it propagates."""
    from gofr_tpu_torch.ops import autotune as pat
    from gofr_tpu_torch.ops.cuda import KernelError

    def refused(exc):
        def fn():
            raise exc("the kernel refused the plan")
        return fn

    def timer(fn):
        fn()
        return 1e-3

    jt, pt = _tuners(timer=timer)
    assert jt.measure("decode", "8x16", "bf16",
                      {"xla": lambda: None, "pallas": refused(RuntimeError)}) == "xla"
    assert pt.measure("decode", "8x16", "bf16",
                      {"rows192": lambda: None, "rows64": refused(pat.Disqualified)}) == "rows192"
    assert (_neutral(jt.decisions["decode"], JAX_NAMES)
            == _neutral(pt.decisions["decode"], PORT_NAMES))
    assert "refused" in pt.decisions["decode"]["errors"]["rows64"]
    with pytest.raises(pat.Disqualified, match="refused"):
        pt.measure("paged_decode", "8x16", "bf16",
                   {"rows192": refused(pat.Disqualified), "rows64": refused(pat.Disqualified)})
    for exc in (KernelError, RuntimeError):
        with pytest.raises(exc, match="refused"):
            pt.measure("paged_decode_q", "8x16", "int8",
                       {"rows192": lambda: None, "rows64": refused(exc)})
    assert "paged_decode" not in pt.decisions and "paged_decode_q" not in pt.decisions


@pytest.mark.quick
@pytest.mark.parametrize("timings,winner", [
    # (best, spread) seconds of the rule's plan, then two others
    ([(1.00e-3, 0.10e-3), (0.95e-3, 0.02e-3), (0.97e-3, 0.0)], "rows192"),
    ([(1.00e-3, 0.02e-3), (0.95e-3, 0.10e-3), (0.99e-3, 0.0)], "rows192"),
    ([(1.00e-3, 0.02e-3), (0.95e-3, 0.01e-3), (0.90e-3, 0.11e-3)], "rows64"),
    ([(1.00e-3, 0.02e-3), (0.95e-3, 0.01e-3), (0.90e-3, 0.05e-3)], "rows384"),
])
def test_a_plan_inside_the_timer_spread_keeps_the_rule(timings, winner):
    """A plan replaces the rule's (the first) only when it is faster by
    more than the larger of the two spreads; among those, the fastest.
    The record keeps each plan's spread beside its time."""
    from gofr_tpu_torch.ops import autotune as pat

    pt = _tuners(timings=[pat.Timing(*t) for t in timings])[1]
    names = ("rows192", "rows64", "rows384")
    assert pt.measure("paged_decode", "8x16", "bf16", _cands(names)) == winner
    rec = pt.decisions["paged_decode"]
    assert rec["spread_ms"] == {n: round(t[1] * 1e3, 4) for n, t in zip(names, timings)}
    assert rec["timings_ms"] == {n: round(t[0] * 1e3, 4) for n, t in zip(names, timings)}


@pytest.mark.quick
def test_cache_round_trip_and_role_keys_match_jax(tmp_path):
    """Decisions persist under JAX's key (``|role=`` for a role worker);
    a second tuner pins from the file without timing; another device or
    role is measured afresh."""
    from gofr_tpu.ops import autotune as jat
    from gofr_tpu_torch.ops import autotune as pat

    for role in ("", "decode"):
        assert (pat.entry_key("H100", "paged_decode", "8x16", "bf16", role)
                == jat.entry_key("H100", "paged_decode", "8x16", "bf16", role))
    assert pat.entry_key("H100", "x", "1", "int8", "both") == "H100|x|1|int8"
    jt, pt = _tuners(tmp_path, timings=[2e-3, 1e-3], role="decode")
    jt.measure("paged_decode_q", "8x16", "int8", _cands(JAX_NAMES))
    pt.measure("paged_decode_q", "8x16", "int8", _cands(PORT_NAMES))
    assert pt.report()["role"] == jt.report()["role"] == "decode"
    key = pat.entry_key("H100", "paged_decode_q", "8x16", "int8", "decode")
    jdoc = json.loads((tmp_path / "jax.json").read_text())
    pdoc = json.loads((tmp_path / "port.json").read_text())
    assert pdoc["version"] == jdoc["version"] == pat.FORMAT_VERSION == 1
    assert set(pdoc["entries"]) == set(jdoc["entries"]) == {key}
    assert pdoc["entries"][key]["backend"] == "rows64"
    assert set(pdoc["entries"][key]) == set(jdoc["entries"][key]) == {"backend", "timings_ms", "at"}

    def no_timer(fn):
        raise AssertionError("re-timed despite a cache hit")

    for role, source in (("decode", "cache"), ("", "measured")):
        kw = dict(timer=no_timer) if source == "cache" else dict(timings=[1e-3, 2e-3])
        jt2, pt2 = _tuners(tmp_path, role=role, **kw)
        jw = jt2.measure("paged_decode_q", "8x16", "int8", _cands(JAX_NAMES))
        pw = pt2.measure("paged_decode_q", "8x16", "int8", _cands(PORT_NAMES))
        assert JAX_NAMES.index(jw) == PORT_NAMES.index(pw)
        assert jt2.decisions["paged_decode_q"]["source"] == source
        assert pt2.decisions["paged_decode_q"]["source"] == source


@pytest.mark.quick
@pytest.mark.parametrize("content", [
    "not json at all {",
    json.dumps({"version": 999, "entries": {"k": {"backend": "rows64"}}}),
    json.dumps({"version": 1, "entries": "nope"}),
    json.dumps({"version": 1, "entries": {"H100|decode|8x16|int8": {"backend": "cuda"}}}),
])
def test_corrupt_or_stale_cache_is_ignored_as_in_jax(tmp_path, content):
    (tmp_path / "jax.json").write_text(content.replace("rows64", "pallas"))
    (tmp_path / "port.json").write_text(content)
    jt, pt = _tuners(tmp_path, timings=[2e-3, 1e-3])
    jw = jt.measure("decode", "8x16", "int8", _cands(JAX_NAMES))
    pw = pt.measure("decode", "8x16", "int8", _cands(PORT_NAMES))
    assert JAX_NAMES.index(jw) == PORT_NAMES.index(pw) == 1
    assert pt.decisions["decode"]["source"] == jt.decisions["decode"]["source"] == "measured"
    assert json.loads((tmp_path / "port.json").read_text())["version"] == 1


@pytest.mark.quick
def test_the_torch_cache_file_and_jax_s_keep_each_other_s_entries(tmp_path, monkeypatch):
    """Both packages read ``GOFR_AUTOTUNE_CACHE``; the port writes
    ``<path>.torch``. Written in turn, neither file loses the other
    package's decisions (one shared file would: each ``_load_cache``
    drops the other's backend names)."""
    from gofr_tpu.ops import autotune as jat
    from gofr_tpu_torch.ops import autotune as pat

    path = str(tmp_path / "autotune.json")
    monkeypatch.setenv("GOFR_AUTOTUNE_CACHE", path)
    assert pat.cache_path() == path + ".torch" and jat.cache_path() == path
    for i, (op, jt_first) in enumerate((("paged_decode", True), ("decode", False))):
        order = ((jat, JAX_NAMES), (pat, PORT_NAMES))
        for mod, names in (order if jt_first else order[::-1]):
            t = mod.Autotuner(device_kind="H100", cache_file=mod.cache_path(),
                              timer=_fake_timer([2e-3, 1e-3]))
            t.measure(op, f"8x{i}", "bf16", _cands(names))
    jdoc = json.loads((tmp_path / "autotune.json").read_text())["entries"]
    pdoc = json.loads((tmp_path / "autotune.json.torch").read_text())["entries"]
    assert {rec["backend"] for rec in jdoc.values()} == {"pallas"} and len(jdoc) == 2
    assert {rec["backend"] for rec in pdoc.values()} == {"rows64"} and len(pdoc) == 2
    assert set(jdoc) == set(pdoc)
    # and a port file handed to JAX (or the reverse) is read as empty
    assert jat._load_cache(path + ".torch") == {} and pat._load_cache(path) == {}


@pytest.mark.quick
def test_enabled_only_on_the_card_and_not_under_gofr_autotune_0(monkeypatch):
    from gofr_tpu_torch.ops import autotune

    monkeypatch.delenv("GOFR_AUTOTUNE", raising=False)
    monkeypatch.setenv("GOFR_PALLAS", "1")  # not read by the port
    assert autotune.enabled(torch.device("cuda", 0)) and autotune.enabled("cuda")
    assert not autotune.enabled(torch.device("cpu"))
    monkeypatch.setenv("GOFR_AUTOTUNE", "0")
    assert not autotune.enabled(torch.device("cuda", 0))


# -- the plans --------------------------------------------------------------------


@pytest.mark.quick
@pytest.mark.parametrize("n,hkv,smax", [(8, 8, 2176), (9, 8, 2048), (8, 8, 2304), (4, 2, 72),
                                        (256, 8, 2176), (1, 1, 64)])
def test_candidates_start_with_the_rule_and_are_whole_tiles(n, hkv, smax):
    from gofr_tpu_torch.ops.cuda.decode_attention import TILE, split_candidates, split_plan

    cands = split_candidates(n, hkv, smax)
    whole = TILE * -(-smax // TILE)
    assert cands[0] == split_plan(n, hkv, smax)[0]
    assert len(set(cands)) == len(cands) and whole in cands
    assert all(c % TILE == 0 and TILE <= c <= whole for c in cands)
    if (n, hkv, smax) == (8, 8, 2176):
        assert cands == [192, 64, 384, 768, 2176]


@pytest.mark.quick
def test_a_pin_is_honoured_only_at_its_shape_key():
    """``split_scratch`` takes the pinned rows for the op at the shape (and
    cache dtype) it was measured at; another shape, another op or no scope
    keeps ``split_plan``'s plan, and the scratch follows the plan's
    splits."""
    from gofr_tpu_torch.ops import autotune
    from gofr_tpu_torch.ops.cuda.decode_attention import split_plan, split_scratch

    n, hq, hkv, d, page, maxp, pool = 9, 32, 8, 128, 128, 16, 144
    q = torch.zeros(n, hq, d)
    shape = (n, hq, hkv, d, page, maxp, pool)
    dims = (*shape, "bfloat16")
    rule = split_plan(n, hkv, maxp * page)
    key = autotune.shape_key(*shape)
    assert autotune.pin_dims(key, "bfloat16") == dims
    kv = {"paged_decode": "bfloat16"}
    assert split_scratch(q, hkv, maxp * page, "paged_decode", dims)[:2] == rule
    with autotune.decision_scope({"paged_decode": "rows1024"}, {"paged_decode": key}, kv):
        rows, splits, scratch = split_scratch(q, hkv, maxp * page, "paged_decode", dims)
        assert (rows, splits) == (1024, 2) and scratch.numel() == n * hq * 2 * (d + 2)
        other = (n, hq, hkv, d, page, maxp, pool + 1, "bfloat16")
        assert split_scratch(q, hkv, maxp * page, "paged_decode", other)[:2] == rule
        assert split_scratch(q, hkv, maxp * page, "paged_decode_q", dims)[:2] == rule
        assert autotune.pinned_plan("paged_decode", dims) == 1024
        with autotune.decision_scope({"paged_decode": "rows2048"}, {"paged_decode": key}, kv):
            rows, splits, scratch = split_scratch(q, hkv, maxp * page, "paged_decode", dims)
            assert (rows, splits, scratch.numel()) == (2048, 1, 0)
    assert split_scratch(q, hkv, maxp * page, "paged_decode", dims)[:2] == rule
    assert autotune.pinned_plan("paged_decode", dims) is None


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["slot", "paged", "int8", "int4"])
def test_split_plain_at_every_candidate_equals_the_unsplit_plain(kind):
    from gofr_tpu_torch.ops import attention as A
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates

    rng = np.random.default_rng(3)
    n, hq, hkv, d, page, maxp, pool = 3, 4, 2, 16, 8, 24, 80
    q = torch.from_numpy(rng.standard_normal((n, hq, d)).astype(np.float32))
    table = torch.from_numpy(rng.permutation(pool)[: n * maxp].reshape(n, maxp).astype(np.int32))
    lengths = torch.tensor([maxp * page, 129, 64], dtype=torch.int32)
    span = maxp * page
    if kind == "slot":
        kc = torch.from_numpy(rng.standard_normal((n, hkv, span, d)).astype(np.float32))
        vc = torch.from_numpy(rng.standard_normal((n, hkv, span, d)).astype(np.float32))
        want = A.decode_attention_plain(q, kc, vc, lengths)
        split = lambda r: A.decode_attention_split_plain(q, kc, vc, lengths, r)  # noqa: E731
    elif kind == "paged":
        kp = torch.from_numpy(rng.standard_normal((pool, hkv, page, d)).astype(np.float32))
        vp = torch.from_numpy(rng.standard_normal((pool, hkv, page, d)).astype(np.float32))
        want = A.paged_decode_attention_plain(q, kp, vp, table, lengths)
        split = lambda r: A.paged_decode_attention_split_plain(q, kp, vp, table, lengths, r)  # noqa: E731
    else:
        bits = 8 if kind == "int8" else 4
        width = d if bits == 8 else d // 2
        dt = torch.int8 if bits == 8 else torch.uint8
        lo, hi = (-127, 128) if bits == 8 else (0, 256)
        kq = torch.from_numpy(rng.integers(lo, hi, (pool, hkv, page, width))).to(dt)
        vq = torch.from_numpy(rng.integers(lo, hi, (pool, hkv, page, width))).to(dt)
        ks = torch.from_numpy(rng.uniform(0.005, 0.05, (pool, hkv, page)).astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.02, 0.2, (pool, hkv, page)).astype(np.float32))
        plain = A.paged_decode_attention_q_plain if bits == 8 else A.paged_decode_attention_q4_plain
        want = plain(q, kq, vq, ks, vs, table, lengths)
        split = lambda r: A.paged_decode_attention_q_split_plain(  # noqa: E731
            q, kq, vq, ks, vs, table, lengths, r, bits=bits)
    cands = split_candidates(n, hkv, span)
    assert cands == [64, 128, 192]
    for rows in cands:
        np.testing.assert_allclose(split(rows).numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# -- the engine seam --------------------------------------------------------------


def _split_plain_launch(op, rows, skey, q, planes, lengths):
    """The candidate launcher the engine tests inject: the split plain
    version of the op's kernel at plan ``rows`` (on the card the engine
    launches the kernel with ``rows`` pinned)."""
    from gofr_tpu_torch.ops import attention as A

    if op == "decode":
        return A.decode_attention_split_plain(q, *planes, lengths, rows)
    if op == "paged_decode":
        return A.paged_decode_attention_split_plain(q, *planes, lengths, rows)
    return A.paged_decode_attention_q_split_plain(q, *planes, lengths, rows,
                                                  bits=8 if op == "paged_decode_q" else 4)


def _engine(container=None, **kw):
    from gofr_tpu_torch.gpu.engine import GenerateEngine, build_engine

    base = build_engine("tiny", device="cpu", seed=0, slots=2, max_len=64, page_size=8,
                        kv_quantize=kw.get("kv_quantize", ""),
                        kv_layout=kw.get("kv_layout", "paged"))
    base.stop()
    kwargs = dict(device="cpu", slots=2, max_len=64, page_size=8, prefill_buckets=[16])
    kwargs.update(kw)
    eng = GenerateEngine(base.model, container=container, **kwargs)
    eng._autotune_launch = _split_plain_launch
    return eng


@pytest.fixture
def tuned(monkeypatch, tmp_path):
    """``enabled`` patched true (the CPU is never tuned otherwise) and the
    cache under ``tmp_path``."""
    from gofr_tpu_torch.ops import autotune

    monkeypatch.delenv("GOFR_AUTOTUNE", raising=False)
    monkeypatch.setenv("GOFR_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "enabled", lambda device=None: True)
    return tmp_path


@pytest.mark.quick
@pytest.mark.parametrize("kv", [("paged", ""), ("paged", "int8"), ("paged", "int4"),
                                ("slot", "")])
def test_engine_warmup_measures_pins_reports_and_caches(tuned, kv):
    """warmup() times the plans on the engine's shapes (fake timer here),
    pins the winner, exposes the report, the info gauge and the pins in
    the quality snapshot, serves the same tokens; a restarted engine pins
    from the ``.torch`` file without timing."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates

    layout, quant = kv
    op = {("paged", ""): "paged_decode", ("paged", "int8"): "paged_decode_q",
          ("paged", "int4"): "paged_decode_q4", ("slot", ""): "decode"}[kv]
    c = new_mock_container()
    eng = _engine(c, kv_layout=layout, kv_quantize=quant, quality_shadow_rate=1.0)
    span = eng.pages_per_slot * 8 if layout == "paged" else eng.cache_len
    plans = split_candidates(2, eng.cfg.num_kv_heads, span)
    assert len(plans) >= 2
    timed = []

    def fake_timer(fn):
        fn()
        timed.append(fn)
        return [2e-3, 1e-3, 3e-3, 4e-3, 5e-3][len(timed) - 1]

    eng._autotune_timer = fake_timer
    try:
        before = eng.generate([1, 2, 3, 4, 5], max_new_tokens=5)["tokens"]
        assert eng.autotune_report() is None
        eng.warmup()
        after = eng.generate([1, 2, 3, 4, 5], max_new_tokens=5)["tokens"]
    finally:
        eng.stop()
    assert before == after and len(timed) == len(plans)
    winner = f"rows{plans[1]}"
    assert eng._autotune_pins == {op: winner}
    rep = eng.autotune_report()
    rec = rep["decisions"][op]
    assert rec["source"] == "measured" and rep["rule"] == f"rows{plans[0]}"
    assert list(rec["timings_ms"]) == [f"rows{r}" for r in plans] and "errors" not in rec
    # a quantized pool's pins carry the query's dtype too (kernel D has an
    # f32-q build): the tiny model is f32
    assert rec["kv_dtype"] == (f"{quant}/float32" if quant else "float32")
    gauge = c.metrics.get("app_tpu_kernel_backend")
    vals = {dict(ls)["backend"]: v for ls, v in gauge._values.items() if dict(ls)["op"] == op}
    assert vals == {f"rows{r}": (1.0 if f"rows{r}" == winner else 0.0) for r in plans}
    snap = eng.quality_snapshot()
    assert snap is not None and snap["autotune_pins"] == {op: winner}

    eng2 = _engine(kv_layout=layout, kv_quantize=quant)

    def no_timer(fn):
        raise AssertionError("re-timed despite the autotune cache")

    eng2._autotune_timer = no_timer
    try:
        eng2.warmup()
    finally:
        eng2.stop()
    assert eng2._autotune_pins == {op: winner}
    assert eng2.autotune_report()["decisions"][op]["source"] == "cache"
    assert (tuned / "autotune.json.torch").exists() and not (tuned / "autotune.json").exists()


@pytest.mark.quick
def test_engine_stands_down_without_the_tuner_and_on_the_prefill_role(monkeypatch, tmp_path):
    """Off the card (``enabled`` as it is) and under ``GOFR_AUTOTUNE=0``:
    no pins, no report; on the int8 slot cache, which has no split
    kernel: no report; a prefill worker records why it skipped."""
    import os

    from gofr_tpu_torch.ops import autotune

    monkeypatch.setenv("GOFR_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.delenv("GOFR_AUTOTUNE", raising=False)
    cases = [("cpu", {}, None)]
    for setup, kw, want in cases + [("off", {}, None),
                                     ("slot_int8", dict(kv_layout="slot", kv_quantize="int8"), None),
                                     ("prefill", dict(role="prefill"), "skip")]:
        if setup == "off":
            monkeypatch.setattr(autotune, "enabled",
                                lambda device=None: os.environ.get("GOFR_AUTOTUNE") != "0")
            monkeypatch.setenv("GOFR_AUTOTUNE", "0")
        elif setup != "cpu":
            monkeypatch.delenv("GOFR_AUTOTUNE", raising=False)
        eng = _engine(**kw)
        eng._autotune_timer = lambda fn: 1e-3
        try:
            eng.warmup()
        finally:
            eng.stop()
        assert eng._autotune_pins == {}, setup
        if want is None:
            assert eng.autotune_report() is None, setup
        else:
            assert eng.autotune_report() == {"skipped": "prefill role: no decode ops to tune"}
    assert not list(tmp_path.iterdir())


@pytest.mark.quick
def test_a_decode_worker_keys_its_pins_by_role_and_a_restart_keeps_them(tuned):
    eng = _engine(role="decode", prefix_host_mb=1.0)
    eng._autotune_timer = lambda fn: 1e-3
    try:
        eng.warmup()
        assert eng.autotune_report()["role"] == "decode"
        pins = dict(eng._autotune_pins)
        eng._reset_device_state()
        eng._autotune_timer = lambda fn: (_ for _ in ()).throw(AssertionError("re-measured"))
        eng.warmup()
    finally:
        eng.stop()
    assert eng._autotune_pins == pins
    doc = json.loads((tuned / "autotune.json.torch").read_text())["entries"]
    assert len(doc) == 1 and next(iter(doc)).endswith("|role=decode")


@pytest.mark.quick
def test_a_plan_that_disagrees_is_disqualified_and_all_failing_raises(tuned):
    """A candidate whose output is outside the launcher's limits against
    the rule's plan is disqualified with its error recorded; when every
    candidate fails (the rule's plan among them), warmup raises."""
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates

    eng = _engine()
    plans = split_candidates(eng.num_slots, eng.cfg.num_kv_heads, eng.pages_per_slot * 8)
    bad = f"rows{plans[1]}"

    def skewed(op, rows, *args):
        out = _split_plain_launch(op, rows, *args)
        return out + 1.0 if rows == plans[1] else out

    eng._autotune_launch = skewed

    def timer(fn):
        fn()
        return 1e-3

    eng._autotune_timer = timer
    try:
        eng.warmup()
    finally:
        eng.stop()
    rec = eng.autotune_report()["decisions"]["paged_decode"]
    assert bad in rec["errors"] and "disagrees" in rec["errors"][bad]
    assert rec["backend"] != bad

    def dies(*args):
        raise RuntimeError("no plan runs")

    eng = _engine(kv_quantize="int8")
    eng._autotune_launch = dies
    eng._autotune_timer = timer
    try:
        with pytest.raises(RuntimeError, match="no plan runs"):
            eng.warmup()
    finally:
        eng.stop()


@pytest.mark.quick
@pytest.mark.parametrize("which,fault", [
    ("rule", "kernel"), ("rule", "device"), ("other", "kernel"), ("other", "device")])
def test_a_kernel_or_device_fault_in_any_plan_fails_warmup(tuned, which, fault):
    """A candidate that raises anything but a disqualification (a
    ``KernelError``, a CUDA error) is no losing plan: warmup raises it,
    pins nothing, and the engine keeps the rule's plan."""
    from gofr_tpu_torch.ops.cuda import KernelError
    from gofr_tpu_torch.ops.cuda.decode_attention import split_candidates

    eng = _engine()
    plans = split_candidates(eng.num_slots, eng.cfg.num_kv_heads, eng.pages_per_slot * 8)
    failing = plans[0] if which == "rule" else plans[-1]
    exc = (KernelError("gofr_paged_decode_q: launch failed") if fault == "kernel" else
           RuntimeError("CUDA error: an illegal memory access was encountered"))

    def launch(op, rows, *args):
        if rows == failing:
            raise exc
        return _split_plain_launch(op, rows, *args)

    def timer(fn):
        fn()
        return 1e-3

    eng._autotune_launch, eng._autotune_timer = launch, timer
    try:
        with pytest.raises(type(exc), match=str(exc).split(":")[0]):
            eng.warmup()
        assert eng._autotune_pins == {} and eng.autotune_report() is None
        assert eng.generate([1, 2, 3], max_new_tokens=3)["tokens"]
    finally:
        eng.stop()
    assert not (tuned / "autotune.json.torch").exists()
