"""The port's online step controller (gofr_tpu_torch.control and the
engine's knob seams) held against the JAX package's (gofr_tpu/control/,
tests/test_control.py).

Three layers, as the JAX suite has them:

- the hysteresis gate and the controller on fake clocks and synthetic
  windows: every scenario of ``TestHysteresisGate`` and
  ``TestStepController`` runs on both packages and the decisions
  (``Decision.to_dict()``), knob values and backoffs must be equal; a pin
  cache written by either package resumes in the other;
- the band-labelled evidence: ``occupancy_band`` and ``band_totals`` equal
  JAX's on the same steps, and after the same traffic an engine's band
  rows carry the JAX engine's keys;
- the engine seams on tiny f32 paged engines of both packages: the same
  prompts and the same ``request_knobs`` pokes give the same tokens and
  the same ``knob_vector()`` (the clamps included), ``CONTROL_ENABLE``
  through ``build_engine`` builds a controller whose report has the JAX
  controller's keys and ranges, and ``/debug/control`` answers through the
  port's App.

Tolerances: none — decisions, knob vectors and greedy f32 tokens are
exact.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

PACKAGES = ("jax", "torch")


def _control(pkg: str):
    """(controller module, hysteresis module) of one package."""
    if pkg == "jax":
        from gofr_tpu.control import controller, hysteresis
    else:
        from gofr_tpu_torch.control import controller, hysteresis
    return controller, hysteresis


# -- hysteresis gate -----------------------------------------------------------------


def _gate(hyst, **kw):
    kw.setdefault("sustain_s", 2.0)
    kw.setdefault("idle_s", 4.0)
    kw.setdefault("cooldown_hot_s", 3.0)
    kw.setdefault("cooldown_calm_s", 5.0)
    kw.setdefault("stale_s", 60.0)
    return hyst.HysteresisGate(**kw)


def _gate_hot_requires_sustain(g):
    return [g.decide(hot=True, calm=False, now=t) for t in (0.0, 1.9, 2.0)]


def _gate_blip_resets(g):
    out = [g.decide(hot=True, calm=False, now=0.0), g.decide(hot=False, calm=True, now=1.0)]
    return out + [g.decide(hot=True, calm=False, now=t) for t in (2.0, 4.0)]


def _gate_band_accumulates_neither(g):
    return [g.decide(hot=True, calm=False, now=0.0), g.decide(hot=False, calm=False, now=1.0),
            g.decide(hot=True, calm=False, now=2.5)]


def _gate_cooldown_anchors_on_action(g):
    out = [g.decide(hot=True, calm=False, now=0.0), g.decide(hot=True, calm=False, now=2.0)]
    g.note_action(2.0)
    return out + [g.decide(hot=True, calm=False, now=t) for t in (2.5, 4.9, 5.0)]


def _gate_calm_cooldown(g):
    g.note_action(0.0)
    return [g.decide(hot=False, calm=True, now=t) for t in (1.0, 4.9, 5.0)]


def _gate_stale_freezes(g):
    out = [g.decide(hot=True, calm=False, now=0.0),
           g.decide(hot=True, calm=False, now=1.0, age_s=61.0)]
    return out + [g.decide(hot=True, calm=False, now=t) for t in (2.0, 4.0)]


GATE_SCENARIOS = {
    "hot_requires_sustain": (_gate_hot_requires_sustain, ["hold", "hold", "hot"]),
    "blip_resets_the_streak": (_gate_blip_resets, ["hold", "hold", "hold", "hot"]),
    "band_accumulates_neither": (_gate_band_accumulates_neither, ["hold", "hold", "hold"]),
    "cooldown_anchors_on_note_action": (_gate_cooldown_anchors_on_action,
                                        ["hold", "hot", "hold", "hold", "hot"]),
    "calm_uses_idle_and_its_own_cooldown": (_gate_calm_cooldown, ["hold", "hold", "calm"]),
    "stale_freezes_and_forgets": (_gate_stale_freezes, ["hold", "freeze", "hold", "hot"]),
}


@pytest.mark.quick
@pytest.mark.parametrize("scenario", list(GATE_SCENARIOS))
def test_the_gate_decides_as_the_jax_gate(scenario):
    """Each ``TestHysteresisGate`` scenario: the same verdicts in the same
    order as JAX's gate (and as the JAX suite expects), the same state."""
    run, want = GATE_SCENARIOS[scenario]
    outs = {}
    for pkg in PACKAGES:
        g = _gate(_control(pkg)[1])
        outs[pkg] = (run(g), g.state())
    assert outs["torch"][0] == want
    assert outs["torch"] == outs["jax"]


# -- the controller on fake clocks ---------------------------------------------------


def win(score: float, *, steps: int = 10, band: str = "hi", bubble_ratio: float = 0.0) -> dict:
    """A synthetic band_totals payload whose score is exactly ``score``
    (tests/test_control.py ``win``)."""
    attain = score / (1.0 - bubble_ratio)
    bubble = bubble_ratio / (1.0 - bubble_ratio)
    return {f"decode|bf16|{band}": {
        "flops": attain, "bytes": 0.0, "device_s": 1.0, "steps": float(steps),
        "bubble_s": bubble, "flops_cap": 1.0, "bytes_cap": 1.0}}


class ValueKnob:
    def __init__(self, ctl_mod, name, values, value):
        self.value = value
        self.applied = []
        self.spec = ctl_mod.KnobSpec(name, tuple(values), lambda: self.value, self._apply)

    def _apply(self, v):
        self.value = v
        self.applied.append(v)


def make_ctl(ctl_mod, windows, *, values=(1, 2, 3), value=1, standdown=None, cache="",
             **policy_kw):
    """A fake-clock controller over one ``pipeline_depth`` knob; ``windows``
    is consumed one per tick (the last repeats)."""
    policy_kw.setdefault("interval_s", 1.0)
    policy_kw.setdefault("sustain_s", 1.0)
    policy_kw.setdefault("idle_s", 100.0)
    policy_kw.setdefault("cooldown_s", 1.0)
    policy_kw.setdefault("stale_s", 1000.0)
    policy_kw.setdefault("min_steps", 2)
    policy_kw.setdefault("backoff_s", 10.0)
    policy_kw.setdefault("cache_path", cache)
    policy_kw.setdefault("knobs", ("pipeline_depth",))
    knob = ValueKnob(ctl_mod, "pipeline_depth", values, value)
    windows = list(windows)
    seen_since = []

    def window_fn(now, since):
        seen_since.append(since)
        return windows.pop(0) if len(windows) > 1 else windows[0]

    ctl = ctl_mod.StepController(ctl_mod.ControlPolicy(**policy_kw), [knob.spec],
                                 window_fn=window_fn, standdown_fn=standdown,
                                 clock=lambda: 0.0)
    return ctl, knob, seen_since


def _trace(ctl, knob, seen, ticks):
    """Tick at each time; the decisions, knob values and window starts."""
    out = []
    for t in ticks:
        d = ctl.maybe_tick(t)
        out.append((t, d.to_dict() if d is not None else None, knob.value))
    return {"ticks": out, "applied": knob.applied, "since": seen,
            "backoff": {f"{k[0]}|{k[1]}": v for k, v in ctl._backoff.items()},
            "frozen": sorted(ctl._frozen), "oscillating": ctl.oscillating,
            "decisions": [d.to_dict() for d in ctl.decisions]}


CTL_SCENARIOS = {
    "hot_window_proposes_then_commits": (
        dict(windows=[win(0.10), win(0.10), win(0.20)]), (1.0, 2.0, 3.0),
        ["try", "commit"]),
    "worsening_move_reverts_and_backs_off": (
        dict(windows=[win(0.20), win(0.20), win(0.10)]), (1.0, 2.0, 3.0, 5.0, 8.0, 12.0, 13.0),
        ["try", "revert", "try"]),
    "backoff_doubles_capped": (
        dict(windows=[win(0.20), win(0.20), win(0.10)], backoff_s=2.0, backoff_cap_s=3.0),
        (1.0, 2.0, 3.0), ["try", "revert"]),
    "oscillating_commits_freeze_the_knob": (
        dict(windows=[win(0.10 * (1.04 ** i)) for i in range(12)], values=(1, 2)),
        tuple(float(t) for t in range(1, 30)), None),
    "standdown_parks_with_one_decision": (
        dict(windows=[win(0.10)], standdown=lambda: "lockstep"), (1.0, 2.0, 3.0, 4.0),
        ["standdown"]),
    "starved_window_accumulates": (
        dict(windows=[win(0.10, steps=1), win(0.10, steps=1), win(0.10)], min_steps=5),
        (1.0, 2.0, 3.0, 4.0), None),
    "trial_without_evidence_reverts_unjudged": (
        dict(windows=[win(0.10), win(0.10), win(0.10, steps=0)], max_trial_ticks=2),
        (1.0, 2.0, 3.0, 4.0), ["try", "revert"]),
    "bubble_pressure_and_calm_band": (
        dict(windows=[win(0.5, bubble_ratio=0.3), win(0.5, bubble_ratio=0.3),
                      win(0.7, band="mid"), win(0.9, bubble_ratio=0.01)]),
        (1.0, 2.0, 3.0, 4.0, 5.0, 6.0), None),
}


@pytest.mark.quick
@pytest.mark.parametrize("scenario", list(CTL_SCENARIOS))
def test_the_controller_decides_as_the_jax_controller(scenario):
    """Each ``TestStepController`` scenario on both packages: equal
    ``Decision.to_dict()`` sequences, knob values after every tick, window
    starts read, backoffs, frozen knobs and the oscillation flag; and the
    verdicts the JAX suite expects."""
    kw, ticks, verdicts = CTL_SCENARIOS[scenario]
    traces = {}
    for pkg in PACKAGES:
        ctl, knob, seen = make_ctl(_control(pkg)[0], **kw)
        traces[pkg] = _trace(ctl, knob, seen, ticks)
    assert traces["torch"] == traces["jax"]
    got = [d["verdict"] for d in traces["torch"]["decisions"]]
    if verdicts is not None:
        assert got == verdicts
    if scenario == "oscillating_commits_freeze_the_knob":
        assert traces["torch"]["oscillating"] and traces["torch"]["frozen"] == ["pipeline_depth"]
    if scenario == "starved_window_accumulates":
        assert traces["torch"]["since"][:3] == [0.0, 0.0, 0.0]


@pytest.mark.quick
def test_summarize_neighbor_and_policy_equal_jax():
    """``_summarize``'s math, ``KnobSpec.neighbor``'s snapping, the
    policy's defaults from a config and its refusals (JAX's message)."""
    bands = {
        "decode|bf16|hi": {"flops": 3.0, "bytes": 1.0, "device_s": 2.0, "steps": 4,
                           "bubble_s": 0.5, "flops_cap": 10.0, "bytes_cap": 10.0},
        "prefill|bf16|lo": {"flops": 1.0, "bytes": 7.0, "device_s": 0.5, "steps": 2,
                            "bubble_s": 0.0, "flops_cap": 10.0, "bytes_cap": 10.0}}
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu_torch.config import DictConfig

    conf = {"CONTROL_INTERVAL_S": "0.5", "CONTROL_KNOBS": "pipeline_depth, spec_tokens",
            "CONTROL_EPSILON": "0.05", "CONTROL_CACHE": "/tmp/x.json"}
    out = {}
    for pkg, cfg in (("jax", JaxConfig(conf)), ("torch", DictConfig(conf))):
        ctl_mod = _control(pkg)[0]
        spec = ctl_mod.KnobSpec("k", (16, 32, 64), lambda: 0, lambda v: None)
        errors = []
        for kw in (dict(bubble_lo=0.5, bubble_hi=0.1), dict(attain_lo=0.8, attain_hi=0.4),
                   dict(interval_s=0.0)):
            with pytest.raises(ValueError) as e:
                ctl_mod.ControlPolicy(**kw)
            errors.append(str(e.value))
        policy = ctl_mod.ControlPolicy.from_config(cfg)
        out[pkg] = (ctl_mod.StepController._summarize(bands),
                    [spec.neighbor(c, d) for c in (48, 20, 16, 64, 32) for d in (1, -1)],
                    errors, vars(policy), ctl_mod.FORMAT_VERSION, ctl_mod.KNOB_NAMES,
                    ctl_mod.entry_key("k", "lo", kv_dtype="int8", device_kind="x", shard="tp1"))
    assert out["torch"] == out["jax"]
    assert out["torch"][3]["sustain_s"] == 1.0 and out["torch"][3]["knobs"] == (
        "pipeline_depth", "spec_tokens")


@pytest.mark.quick
@pytest.mark.parametrize("writer,reader", [("torch", "jax"), ("jax", "torch")])
def test_a_pin_cache_written_by_either_package_resumes_in_the_other(tmp_path, writer, reader):
    """The pin cache is one format: a commit persisted by ``writer`` (a
    foreign replica's pin kept by the read-merge-write) resumes in a fresh
    ``reader`` controller without a trial."""
    cache = tmp_path / "control.json"
    w_mod, r_mod = _control(writer)[0], _control(reader)[0]
    foreign = w_mod.entry_key("pipeline_depth", "hi", kv_dtype="int8", device_kind="v5e",
                              shard="tp4")
    cache.write_text(json.dumps({"version": w_mod.FORMAT_VERSION,
                                 "entries": {foreign: {"value": 3, "at": 0, "score": 0.5}}}))
    ctl, _, _ = make_ctl(w_mod, [win(0.10), win(0.10), win(0.20)], cache=str(cache))
    ctl.maybe_tick(1.0)
    ctl.maybe_tick(2.0)
    assert ctl.maybe_tick(3.0).verdict == "commit"
    data = json.loads(cache.read_text())
    assert data["entries"][foreign]["value"] == 3
    ours = r_mod.entry_key("pipeline_depth", "hi", kv_dtype="bf16", device_kind="cpu",
                           shard="tp1")
    assert data["entries"][ours]["value"] == 2
    ctl2, knob2, _ = make_ctl(r_mod, [win(0.10)], cache=str(cache))
    d = ctl2.maybe_tick(1.0)
    assert (d.verdict, d.frm, d.to) == ("resume", 1, 2) and knob2.value == 2
    # a corrupt or wrong-version cache is an empty one in both
    cache.write_text("{not json")
    assert make_ctl(r_mod, [win(0.10)], cache=str(cache))[0]._pins == {}
    cache.write_text(json.dumps({"version": 999, "entries": {"k": 1}}))
    assert make_ctl(r_mod, [win(0.10)], cache=str(cache))[0]._pins == {}


# -- band-labelled evidence ----------------------------------------------------------


@pytest.mark.quick
def test_band_evidence_equals_jax():
    """``occupancy_band`` at the band edges, and ``band_totals`` (with and
    without ``since``) and the unbanded kind rollup on the same two steps,
    equal JAX's perf plane."""
    from gofr_tpu.metrics import perf as jperf
    from gofr_tpu_torch.metrics import perf as tperf

    occ = [None, 0.0, 0.34, 0.35, 0.69, 0.70, 1.0]
    assert [tperf.occupancy_band(o) for o in occ] == [jperf.occupancy_band(o) for o in occ] == [
        "lo", "lo", "lo", "mid", "mid", "hi", "hi"]
    out = {}
    for pkg, mod in (("jax", jperf), ("torch", tperf)):
        plane = mod.PerfPlane(mod.CostModel(n_params=1e6, weight_bytes=2e6, kv_bytes_per_pos=16.0,
                                            page_bytes=0.0, page_size=0, kv_dtype="bf16",
                                            kv_shards=1), "cpu", window_s=60.0)
        s1 = plane.step("decode", 1e9, 1e6, 100.0)
        s1.t_ready = 100.5
        plane.note(s1, 100.5, band="hi")
        s2 = plane.step("decode", 2e9, 2e6, 101.0)
        s2.t_ready = 102.0
        plane.note(s2, 102.0, band="lo")
        out[pkg] = (plane.band_totals(102.0), plane.band_totals(102.0, since=101.0),
                    plane.window_totals(102.0)["kinds"])
    assert out["torch"] == out["jax"]
    assert set(out["torch"][0]) == {"decode|bf16|hi", "decode|bf16|lo"}


# -- the engine seams ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    from gofr_tpu.models import LlamaConfig, llama
    from gofr_tpu_torch.models.llama import LlamaConfig as PortConfig
    from gofr_tpu_torch.models.llama import params_from_jax

    jcfg = LlamaConfig.tiny()
    params = llama.init(jcfg, jax.random.key(7))
    model = params_from_jax(PortConfig.tiny(), jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, params, model


ENGINE_KW = dict(slots=4, max_len=96, max_prefill_batch=2, decode_chunk=2,
                 prefill_buckets=[16, 32, 48], kv_layout="paged", page_size=8)


def _engine(pkg, tiny, conf=None, **kw):
    kw = {**ENGINE_KW, **kw}
    if pkg == "jax":
        from gofr_tpu.container import new_mock_container
        from gofr_tpu.models import llama
        from gofr_tpu.tpu.engine import GenerateEngine

        return GenerateEngine(llama, tiny[0], tiny[1], new_mock_container(conf), **kw)
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import GenerateEngine

    return GenerateEngine(tiny[2], device="cpu", container=new_mock_container(conf), **kw)


def _pokes(eng):
    """The clamp drill of tests/test_control.py on one engine: the knob
    vector after each poke is applied."""
    seen = [eng.knob_vector()]
    for poke in (dict(pipeline_depth=4, prefill_batch=9, spec_tokens=7), dict(prefill_chunk=40),
                 dict(prefill_chunk=1), dict(warp_factor=9), dict(spec_tokens=1),
                 dict(pipeline_depth=0, prefill_batch=-3), dict(prefill_chunk=48, spec_tokens=2,
                                                                  pipeline_depth=2)):
        eng.request_knobs(**poke)
        eng._apply_pending_knobs()
        seen.append(eng.knob_vector())
    return seen


@pytest.mark.quick
@pytest.mark.parametrize("spec_tokens", [2, 0], ids=["spec", "no_spec"])
def test_knob_clamps_equal_the_jax_engine(tiny, spec_tokens):
    """Depth past boot, a batch past boot, a ``prefill_chunk`` between
    buckets and below the smallest, an unknown knob (logged, dropped), and
    ``spec_tokens`` on an engine built without spec (logged, not
    applied): the same knob vectors as the JAX engine's after each poke."""
    out = {}
    for pkg in PACKAGES:
        eng = _engine(pkg, tiny, pipeline_depth=2, spec_tokens=spec_tokens)
        try:
            out[pkg] = _pokes(eng)
            if pkg == "torch":
                lines = eng.container.logger.lines
                assert any("knob warp_factor=9 rejected" in ln for ln in lines)
                assert (not spec_tokens) == any("spec is off at boot" in ln for ln in lines)
                assert eng.chunk_span == (2 * (spec_tokens + 1) + spec_tokens if spec_tokens
                                          else 2)
        finally:
            eng.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][2]["prefill_chunk"] == 32 and out["torch"][3]["prefill_chunk"] == 16


PROMPTS = [np.random.RandomState(3).randint(1, 256, size=n).tolist()
           for n in (8, 39, 12, 25, 33, 9, 40, 17, 28, 21)]


def _drill(eng, flip: bool) -> tuple[list, list]:
    """Submit the prompts; with ``flip`` move every knob after the third
    and back after the seventh, as tests/test_control.py's drill does."""
    reqs, vectors = [], []
    for i, p in enumerate(PROMPTS):
        reqs.append(eng.submit(p, max_new_tokens=12, timeout=120))
        if flip and i == 2:
            eng.request_knobs(prefill_chunk=16, spec_tokens=1, pipeline_depth=1, prefill_batch=1)
        if flip and i == 6:
            eng.request_knobs(prefill_chunk=48, spec_tokens=2, pipeline_depth=2, prefill_batch=2)
    tokens = [r.result(120)["tokens"] for r in reqs]
    vectors.append(eng.knob_vector())
    return tokens, vectors


@pytest.mark.quick
@pytest.mark.parametrize("spec_tokens", [2, 0], ids=["spec", "no_spec"])
def test_midstream_knob_moves_keep_tokens_equal_to_the_jax_engine(tiny, spec_tokens):
    """Every knob moved while requests prefill and decode, and moved back:
    the port's greedy tokens equal its own untouched run's and the JAX
    engine's under the same moves, and both end on the same knob vector.
    Every flight step entry carries a knob vector within the boot
    envelope."""
    runs = {}
    for pkg, flip in (("jax", True), ("torch", True), ("torch", False)):
        eng = _engine(pkg, tiny, pipeline_depth=2, spec_tokens=spec_tokens)
        try:
            runs[pkg, flip] = _drill(eng, flip)
            if pkg == "torch" and flip:
                steps = eng.container.flight.steps()
                assert steps and all("knobs" in st for st in steps)
                for st in steps:
                    k = st["knobs"]
                    assert 1 <= k["pipeline_depth"] <= 2 and 1 <= k["prefill_batch"] <= 2
                    assert k["prefill_chunk"] in ENGINE_KW["prefill_buckets"]
                    assert ("spec_tokens" in k) == bool(spec_tokens)
            if pkg == "torch":
                eng.check_page_refs()
        finally:
            eng.stop()
    assert runs["torch", True] == runs["jax", True]
    assert runs["torch", True][0] == runs["torch", False][0]


def _build(pkg, conf, params=None):
    """An engine from a ``ModelSpec`` and a mock container of ``conf``: the
    JAX one on random weights from seed 7, the port's on ``params`` (the
    JAX engine's, as numpy)."""
    kw = dict(seed=7, slots=4, max_len=96, page_size=8, prefill_buckets=[16, 32, 48],
              max_prefill_batch=2)
    if pkg == "jax":
        import jax.numpy as jnp
        from gofr_tpu.container import new_mock_container
        from gofr_tpu.models import LlamaConfig, ModelSpec
        from gofr_tpu.tpu.engine import build_engine

        container = new_mock_container(conf)
        spec = ModelSpec("llama", LlamaConfig.tiny(), dtype=jnp.float32)
        # the JAX engine's own default layout is the slot cache
        eng = build_engine(spec, container, kv_layout=conf.get("ENGINE_KV_LAYOUT", "paged"),
                           **kw)
        return eng, container, jax.tree.map(np.asarray, eng.params)
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    container = new_mock_container(conf)
    spec = ModelSpec("llama", LlamaConfig.tiny(), weights=params, dtype=torch.float32)
    return build_engine(spec, container, device="cpu", **kw), container, params


@pytest.mark.quick
@pytest.mark.parametrize("conf", [
    {"CONTROL_ENABLE": "1", "CONTROL_INTERVAL_S": "0.5", "ENGINE_SPEC_TOKENS": "2"},
    {"CONTROL_ENABLE": "1", "CONTROL_KNOBS": "prefill_batch"},
    {"CONTROL_ENABLE": "0"},
    {"CONTROL_ENABLE": "1", "CONTROL_BUBBLE_LO": "0.5", "CONTROL_BUBBLE_HI": "0.1"},
], ids=["on_spec", "on_one_knob", "off", "inverted_bands"])
def test_control_enable_through_build_engine_equals_jax(conf):
    """``CONTROL_ENABLE=1`` builds a controller whose report has the JAX
    controller's keys, knobs, allowed ranges, interval and (empty) state;
    ``CONTROL_ENABLE=0`` builds none and reports the knob vector; inverted
    bands leave the engine serving without one, with JAX's logged
    message."""
    out, logs, params = {}, {}, None
    for pkg in PACKAGES:
        eng, container, params = _build(pkg, conf, params)
        try:
            rep = eng.control_report()
            out[pkg] = {k: v for k, v in rep.items() if k not in ("gate",)}
            out[pkg]["gate_keys"] = sorted(rep.get("gate", {}))
            out[pkg]["built"] = eng._control is not None
            logs[pkg] = [ln for ln in container.logger.lines if "step controller disabled" in ln]
        finally:
            eng.stop()
    assert out["torch"] == out["jax"]
    want_built = conf["CONTROL_ENABLE"] == "1" and "CONTROL_BUBBLE_LO" not in conf
    assert out["torch"]["built"] == want_built
    if "CONTROL_BUBBLE_LO" in conf:
        assert len(logs["torch"]) == len(logs["jax"]) == 1
        assert "CONTROL hysteresis bands inverted" in logs["torch"][0]
    if conf.get("ENGINE_SPEC_TOKENS"):
        assert out["torch"]["knobs"]["spec_tokens"]["allowed"] == [1, 2]
        assert out["torch"]["knobs"]["prefill_chunk"]["allowed"] == [16, 32, 48]
        assert out["torch"]["interval_s"] == 0.5


CACHES = [("paged", ""), ("paged", "int8"), ("paged", "int4"), ("slot", ""), ("slot", "int8")]


@pytest.mark.quick
@pytest.mark.parametrize("kv_layout,kv_quantize", CACHES,
                         ids=["bf16", "int8", "int4", "slot_bf16", "slot_int8"])
def test_control_off_builds_nothing_and_keeps_the_jax_tokens(kv_layout, kv_quantize):
    """``CONTROL_ENABLE=0`` (the default) on each of the five caches: no
    controller, a report of the knob vector alone, and the JAX engine's
    greedy tokens, with the band rows and the knob stamps on."""
    conf = {"CONTROL_ENABLE": "0", "ENGINE_KV_LAYOUT": kv_layout,
            "ENGINE_KV_DTYPE": kv_quantize or "bf16"}
    out, params = {}, None
    for pkg in PACKAGES:
        eng, container, params = _build(pkg, conf, params)
        try:
            assert eng._control is None
            out[pkg] = ([eng.generate(p, max_new_tokens=8, timeout=120)["tokens"]
                         for p in PROMPTS[:3]], eng.control_report())
            if pkg == "torch":
                assert all("knobs" in st for st in container.flight.steps())
        finally:
            eng.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][1]["enabled"] is False


@pytest.mark.quick
def test_band_rows_after_traffic_carry_the_jax_engine_s_keys():
    """The same burst (submitted while the state lock is held, so both
    loops batch it alike) files the perf plane's steps under the same
    ``kind|kv_dtype|band`` rows as the JAX engine's."""
    import time

    keys, params = {}, None
    for pkg in PACKAGES:
        eng, _, params = _build(pkg, {}, params)
        try:
            eng.generate(PROMPTS[0], max_new_tokens=4, timeout=120)
            with eng._state_lock:
                reqs = [eng.submit(p, max_new_tokens=6) for p in PROMPTS[1:7]]
            [r.result(120) for r in reqs]
            deadline = time.monotonic() + 30
            while eng._dq and time.monotonic() < deadline:
                time.sleep(0.01)
            keys[pkg] = set(eng.perf.band_totals(time.monotonic()))
        finally:
            eng.stop()
    assert keys["torch"] == keys["jax"]
    assert any(k.startswith("decode|") for k in keys["torch"])


@pytest.mark.quick
def test_debug_control_through_the_port_app(tiny):
    """``GET /debug/control`` under ``APP_ENV=DEBUG``: each engine's
    ``control_report()`` and the flight recorder's decisions; the
    decisions counter equals the ring, and the knob and active gauges are
    sampled at the scrape."""
    import time
    import urllib.request

    from tests.test_http_server import AppHarness

    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    conf = {"HTTP_PORT": "0", "METRICS_PORT": "0", "APP_ENV": "DEBUG", "CONTROL_ENABLE": "1",
            "CONTROL_INTERVAL_S": "0.05", "CONTROL_MIN_STEPS": "1", "ENGINE_PAGE_SIZE": "8",
            "ENGINE_SLOTS": "4", "ENGINE_MAX_LEN": "96"}
    app = App(config=DictConfig(conf))
    eng = app.serve_model("lm", ModelSpec("llama", LlamaConfig.tiny(), weights=tiny[2],
                                          dtype=torch.float32), device="cpu")
    with AppHarness(app):
        deadline = time.monotonic() + 60
        while not list(eng._control.decisions) and time.monotonic() < deadline:
            reqs = [eng.submit(p, max_new_tokens=8) for p in PROMPTS[:4]]
            [r.result(120) for r in reqs]
        assert list(eng._control.decisions), "no decision in 60 s of traffic"
        with urllib.request.urlopen(f"http://127.0.0.1:{app.http_port}/debug/control",
                                    timeout=30) as r:
            body = json.loads(r.read())["data"]
        with urllib.request.urlopen(f"http://127.0.0.1:{app.metrics_port}/metrics",
                                    timeout=30) as r:
            text = r.read().decode()
    rep = body["engines"]["lm"]
    assert rep["enabled"] is True and set(rep["knobs"]) == {"pipeline_depth", "prefill_chunk",
                                                            "prefill_batch"}
    eng.stop()
    # newest first: decisions made after the GET lead the ring
    ring = app.container.flight.controls()
    assert body["decisions"] and body["decisions"] == ring[len(ring) - len(body["decisions"]):]
    counted = sum(v for ls, v in app.container.metrics.get(
        "app_tpu_control_decisions_total")._values.items())
    assert counted == len(ring)
    assert 'app_tpu_control_active{engine="lm"} 1' in text
    assert 'app_tpu_control_knob{engine="lm",knob="pipeline_depth"}' in text


@pytest.mark.quick
def test_every_recorded_metric_literal_is_registered():
    """tests/test_control.py's lint on the port: the registry drops writes
    to unregistered names, so every literal name the port records must be
    registered somewhere (the controller's family among them)."""
    import pathlib
    import re

    record_re = re.compile(r"(?:increment_counter|set_gauge|record_histogram)\(\s*\n?\s*"
                           r"[\"']([a-z0-9_]+)[\"']")
    register_re = re.compile(r"(?:new_counter|new_updown_counter|new_gauge|new_histogram)\("
                             r"\s*\n?\s*[\"']([a-z0-9_]+)[\"']")
    recorded, registered = {}, set()
    root = pathlib.Path(__file__).resolve().parents[1]
    for p in (root / "gofr_tpu_torch").rglob("*.py"):
        text = p.read_text(errors="ignore")
        for m in record_re.finditer(text):
            recorded.setdefault(m.group(1), set()).add(str(p.relative_to(root)))
        registered.update(m.group(1) for m in register_re.finditer(text))
    missing = {n: sorted(f) for n, f in sorted(recorded.items()) if n not in registered}
    assert registered and not missing, f"recorded but never registered: {missing}"
    for name in ("app_tpu_control_decisions_total", "app_tpu_control_knob",
                 "app_tpu_control_active", "app_tpu_kv_handoff_pages_total"):
        assert name in registered
