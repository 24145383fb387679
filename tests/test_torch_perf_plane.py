"""The port's perf plane (gofr_tpu_torch.metrics.perf, the engine's cost
model and its pricing at each dispatch) held against the JAX package's
(gofr_tpu/metrics/perf.py, gofr_tpu/tpu/engine.py:1347-1387 and the
``step_*`` calls of its executor and decode).

Tolerances: exact. ``device_peaks`` gives the H100 SXM data sheet's pair
for the card's name and None for a card it does not know, and honours the
JAX package's overrides. The engine's ``CostModel`` equals the JAX
engine's on all five caches, with int8 weights and with a draft model
(same storage dtype: the tiny config is float32 in both packages), and
each kind's FLOPs and bytes at the same arguments are equal. Given the
same ``StepPerf`` timings at the same clock, the plane's windows,
band rows, adapter shares and snapshot equal JAX's; adapter shares sum to
the step exactly; ``merge_totals`` / ``derive`` equal JAX's. For the same
traffic, the engine prices every kind's steps, FLOPs and bytes as the
JAX engine does.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

H100 = "NVIDIA H100 80GB HBM3"


def _mods():
    import gofr_tpu.metrics.perf as jp
    import gofr_tpu_torch.metrics.perf as pp

    return jp, pp


@pytest.mark.quick
def test_device_peaks_price_the_h100_sxm_and_nothing_else(monkeypatch):
    """The card's name gives the data sheet's dense bf16 989 TFLOP/s and
    3.35 TB/s (the pair chip_smoke.py's bounds use); ``cpu`` the nominal
    envelope JAX uses; the PCIe and NVL parts and unknown names None."""
    _, pp = _mods()
    for var in ("GOFR_DEVICE_PEAKS", "GOFR_TPU_PEAK_TFLOPS", "GOFR_TPU_PEAK_GBS"):
        monkeypatch.delenv(var, raising=False)
    assert pp.device_peaks(H100) == (989e12, 3.35e12)
    assert pp.device_peaks(H100) == (pp.H100_SXM_BF16_FLOPS, pp.H100_SXM_HBM_BYTES_PER_S)
    assert pp.device_peaks("cpu") == (1e12, 50e9)
    for name in ("NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "TPU v5e", ""):
        assert pp.device_peaks(name) is None


OVERRIDES = [
    {"GOFR_DEVICE_PEAKS": json.dumps({"h100 pcie": [756, 2000]})},
    {"GOFR_DEVICE_PEAKS": "{not json"},
    {"GOFR_TPU_PEAK_TFLOPS": "500"},
    {"GOFR_TPU_PEAK_GBS": "3000", "GOFR_TPU_PEAK_TFLOPS": "x"},
]


@pytest.mark.quick
@pytest.mark.parametrize("env", OVERRIDES, ids=range(len(OVERRIDES)))
def test_the_jax_overrides_keep_their_names(env, monkeypatch):
    """``GOFR_DEVICE_PEAKS`` adds a card (a malformed value is ignored),
    ``GOFR_TPU_PEAK_TFLOPS`` / ``GOFR_TPU_PEAK_GBS`` win per component: on
    every name outside both packages' tables (and ``cpu``) the port
    resolves as JAX does, and on the H100 the override applies over the
    data sheet."""
    jp, pp = _mods()
    for var in ("GOFR_DEVICE_PEAKS", "GOFR_TPU_PEAK_TFLOPS", "GOFR_TPU_PEAK_GBS"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for name in ("NVIDIA H100 PCIe", "cpu", "mystery"):
        assert pp.device_peaks(name) == jp.device_peaks(name)
    flops, bw = pp.device_peaks(H100)
    assert flops == (500e12 if env.get("GOFR_TPU_PEAK_TFLOPS") == "500" else 989e12)
    assert bw == (3000e9 if "GOFR_TPU_PEAK_GBS" in env else 3.35e12)


# -- the cost model -----------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu.ops.quant import quantize_tree
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    qparams = quantize_tree(params)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (jcfg, params, params_from_jax(PortConfig.tiny(), np_(params), device="cpu"),
            qparams, params_from_jax(PortConfig.tiny(), np_(qparams), device="cpu"))


def _pair(tiny, weights="bf16", draft=False, **kw):
    """(JAX engine, port engine) of the same model and knobs, each on a
    mock container (the port's perf plane is on with a container)."""
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.models import llama
    from gofr_tpu.tpu.engine import GenerateEngine as JaxEngine
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    jcfg, params, model, qparams, qmodel = tiny
    kw = {"slots": 4, "max_len": 64, "max_prefill_batch": 2, "page_size": 8, **kw}
    jkw, pkw = dict(kw), dict(kw)
    if draft:
        jkw["spec_draft"] = (llama, jcfg, params)
        pkw["spec_draft"] = (model.cfg, model)
    jweights, pmodel = (qparams, qmodel) if weights == "int8" else (params, model)
    return (JaxEngine(llama, jcfg, jweights, jax_container(), decode_pipeline=2, **jkw),
            GenerateEngine(pmodel, device="cpu", container=new_mock_container(), **pkw))


CACHES = {
    "bf16": dict(kv_layout="paged"), "int8": dict(kv_layout="paged", kv_quantize="int8"),
    "int4": dict(kv_layout="paged", kv_quantize="int4"), "slot_bf16": dict(kv_layout="slot"),
    "slot_int8": dict(kv_layout="slot", kv_quantize="int8"),
    "int8_weights": dict(kv_layout="paged", weights="int8"),
    "slot_int8_weights": dict(kv_layout="slot", weights="int8"),
    "slot_draft": dict(kv_layout="slot", spec_tokens=2, draft=True),
}


@pytest.mark.parametrize("case", list(CACHES))
def test_cost_model_equals_the_jax_engine_s(tiny, case):
    """``describe()`` (parameter count and bytes, KV bytes a position, page
    bytes and size, pool dtype) equals the JAX engine's, and so does each
    kind's (FLOPs, bytes) at the same arguments; the bf16 pool's bytes a
    position are ``kv_plane_bytes_per_position``'s at the tiny config's
    float32."""
    from gofr_tpu.ops.paged import kv_plane_bytes_per_position

    jeng, peng = _pair(tiny, **CACHES[case])
    try:
        got, want = peng.perf.model, jeng.perf.model
        assert got.describe() == want.describe()
        for args in ((1,), (17,), (300,)):
            assert got.prefill(*args) == want.prefill(*args)
        for args in ((16, 0), (5, 32)):
            assert got.chunk(*args) == want.chunk(*args)
        for args in ((1, 8, 9), (4, 8, 256)):
            assert got.decode(*args) == want.decode(*args)
        assert got.spec(3, 8, 4, 100) == want.spec(3, 8, 4, 100)
        assert got.swapin(4096) == want.swapin(4096)
        if case == "bf16":
            cfg = tiny[0]
            assert got.kv_bytes_per_pos == kv_plane_bytes_per_position(
                cfg.num_layers, cfg.num_kv_heads, cfg.hidden_size // cfg.num_heads, "bf16",
                dense_bytes=4)
    finally:
        jeng.stop()
        peng.stop()


# -- the plane's windows ---------------------------------------------------------------------


STEPS = [
    # (kind, flops, bytes, t_dispatch, t_ready, fold at, band occupancy, adapter ids)
    ("prefill", 1e9, 2e8, 100.0, 100.02, 100.021, 0.5, ["a", None]),
    ("decode", 3e8, 9e8, 100.01, 100.05, 100.06, 1.0, ["a", "b", None, "a"]),
    ("decode", 3e8, 9e8, 100.04, 100.09, 100.09, 0.2, None),
    ("prefill_chunk", 5e8, 1e8, 100.2, 100.25, 100.3, 0.75, ["b"]),
    ("swapin", 0.0, 4e6, 100.31, 100.311, 100.32, 1.0, None),
    ("decode_spec", 1e9, 1e9, 130.0, 130.5, 130.5, 0.6, [None, None, None]),
]


def _feed(mod, kind="cpu"):
    plane = mod.PerfPlane(mod.CostModel(n_params=1e6, weight_bytes=2e6, kv_bytes_per_pos=512.0,
                                        page_bytes=4096.0, page_size=8, kv_dtype="int8"),
                          kind, window_s=60.0)
    shares = []
    for n, (k, fl, by, td, tr, now, occ, ids) in enumerate(STEPS):
        p = plane.step(k, fl, by, td)
        p.t_ready = tr
        plane.note(p, now, band=mod.occupancy_band(occ))
        if ids:
            plane.note_adapters(ids, p, now)
            shares.append((p.device_s, ids))
        if n == 2:
            plane.mark_no_work(100.15)
    return plane, shares


@pytest.mark.quick
@pytest.mark.parametrize("kind", ["cpu", H100])
def test_plane_windows_equal_jax_s_for_the_same_timings(kind, monkeypatch):
    """The same ``StepPerf``s with the same dispatch, ready and fold times
    (an idle gap marked between them): ``window_totals``, ``band_totals``
    (whole and since an instant) and ``snapshot`` equal JAX's at two
    clocks, the second past the first steps' window. On the H100 the
    capacities are its peaks (JAX's table has no such row: its plane reads
    the same pair through ``GOFR_DEVICE_PEAKS``)."""
    jp, pp = _mods()
    monkeypatch.setenv("GOFR_DEVICE_PEAKS", json.dumps({"elsewhere": [989, 3350]}))
    got, _ = _feed(pp, kind)
    want, _ = _feed(jp, "elsewhere" if kind == H100 else kind)
    for now in (130.6, 170.0):
        assert got.window_totals(now) == want.window_totals(now)
        assert got.band_totals(now) == want.band_totals(now)
        assert got.band_totals(now, since=100.1) == want.band_totals(now, since=100.1)
        gs, ws = got.snapshot(now), want.snapshot(now)
        for snap in (gs, ws):
            snap.pop("device_kind")
        assert gs == ws


@pytest.mark.quick
def test_adapter_shares_sum_to_the_step_exactly():
    """Each step's per-adapter rows (None lanes as "base") are a partition:
    summed over adapters they equal the kinds' FLOPs, bytes and device
    seconds, and the step's device seconds is what the engine charges."""
    _, pp = _mods()
    plane, shares = _feed(pp)
    totals = plane.window_totals(130.6)
    ad = totals["adapters"]
    kinds = totals["kinds"]
    stepped = {"prefill|int8", "decode|int8", "prefill_chunk|int8", "decode_spec|int8"}
    for f in ("flops", "bytes"):
        credited = sum(fl if f == "flops" else by for k, fl, by, *_, ids in STEPS if ids)
        assert sum(r[f] for r in ad.values()) == pytest.approx(credited, rel=1e-12)
    assert sum(r["device_s"] for r in ad.values()) == pytest.approx(
        sum(d for d, _ in shares), rel=1e-12)
    assert set(ad) == {"a", "b", "base"} and stepped <= set(kinds)
    for d, ids in shares:
        parts = [d / len(ids)] * len(ids)
        assert sum(parts) == pytest.approx(d, rel=1e-15)


@pytest.mark.quick
def test_merge_and_derive_equal_jax_s():
    """``merge_totals`` of two planes' windows and ``derive`` of the merge
    equal JAX's; merging is associative."""
    jp, pp = _mods()
    a, b = _feed(pp)[0].window_totals(130.6), _feed(pp)[0].window_totals(170.0)
    ja, jb = _feed(jp)[0].window_totals(130.6), _feed(jp)[0].window_totals(170.0)
    got, want = pp.merge_totals([a, b, None, {}]), jp.merge_totals([ja, jb, None, {}])
    assert got == want
    assert pp.derive(got) == jp.derive(want)
    assert pp.merge_totals([pp.merge_totals([a]), b]) == got


# -- the engine prices its steps ---------------------------------------------------------


def settle(eng) -> None:
    """Wait until the in-flight queue stays empty."""
    import time

    quiet, deadline = 0, time.monotonic() + 60
    while quiet < 3 and time.monotonic() < deadline:
        quiet = 0 if eng._dq else quiet + 1
        time.sleep(0.02)


PROMPTS = [[5, 3, 9], list(range(1, 21)), [7] * 12, list(range(30, 65)), [2, 4]]


@pytest.mark.parametrize("case", ["bf16", "slot_bf16"])
def test_the_engine_prices_each_kind_as_the_jax_engine(tiny, case):
    """The same burst (submitted at once while the loop waits at its state
    lock) on both engines: per step kind the steps folded, their FLOPs and
    their bytes in the perf window equal the JAX engine's — the prefill's
    prompt tokens, each chunk's offset and each decode chunk's pages or
    positions, all priced from host state at dispatch."""
    import time

    jeng, peng = _pair(tiny, prefill_buckets=[8, 16], **CACHES[case])
    try:
        for eng in (jeng, peng):
            eng.generate([1, 2, 3], max_new_tokens=4, timeout=300)
            settle(eng)
            with eng._state_lock:
                reqs = [eng.submit(p, max_new_tokens=9) for p in PROMPTS]
            [r.result(300) for r in reqs]
            # a chunk of a finished lane can still be in flight: its fold
            # prices it too
            settle(eng)
        now = time.monotonic()
        got = {k: (r["steps"], r["flops"], r["bytes"])
               for k, r in peng.perf.window_totals(now)["kinds"].items()}
        want = {k: (r["steps"], r["flops"], r["bytes"])
                for k, r in jeng.perf.window_totals(now)["kinds"].items()}
    finally:
        jeng.stop()
        peng.stop()
    assert got == want
    assert {"prefill|bf16", "prefill_chunk|bf16", "decode|bf16"} <= set(got)
