"""The launch gate (``gofr_tpu_torch/gpu/launch_gate.py``): a profiler
session starts and stops only while no engine thread launches kernels. On
the card a session started or stopped while another thread launches can
trace no kernel (``scripts/torch_profiler_threads.py``); here, on the CPU,
the tests hold the gate's ordering and that each engine's device thread
keeps to it: a turn waits while a quiet point is held, and an idle engine
lets one in at once."""

from __future__ import annotations

import threading
import time

import pytest

torch = pytest.importorskip("torch")


def _thread(fn) -> threading.Thread:
    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


@pytest.mark.quick
def test_a_quiet_point_waits_for_the_launchers_and_holds_new_ones_back():
    from gofr_tpu_torch.gpu.launch_gate import LaunchGate

    g = LaunchGate()
    inside, release, quiet_in, quiet_out, order = (threading.Event(), threading.Event(),
                                                   threading.Event(), threading.Event(), [])

    def launcher():
        with g.launching():
            inside.set()
            release.wait(10)
            order.append("launcher left")

    def quiet():
        with g.quiet():
            order.append("quiet")
            quiet_in.set()
            quiet_out.wait(10)

    t1 = _thread(launcher)
    assert inside.wait(10) and g.launchers() == 1
    tq = _thread(quiet)
    assert not quiet_in.wait(0.2), "the quiet point began while a launcher was inside"
    release.set()
    assert quiet_in.wait(10)
    entered = threading.Event()

    def late_launcher():
        with g.launching():
            entered.set()

    t2 = _thread(late_launcher)
    assert not entered.wait(0.2), "a launcher entered while the quiet point was held"
    quiet_out.set()
    assert entered.wait(10)
    for t in (t1, tq, t2):
        t.join(10)
    assert order == ["launcher left", "quiet"] and g.launchers() == 0


def test_paused_lets_a_quiet_point_in_and_nesting_does_not_wait_on_itself():
    from gofr_tpu_torch.gpu.launch_gate import LaunchGate

    g = LaunchGate()
    with g.paused():  # outside launching(): nothing
        assert g.launchers() == 0
    idle, got, resumed = threading.Event(), threading.Event(), threading.Event()
    wake = threading.Event()

    def engine():
        with g.launching():
            with g.paused():
                idle.set()
                wake.wait(10)
            # back inside only once the quiet point ended
            resumed.set()
            with g.launching():  # nested: never waits on a pending quiet point
                pass

    def quiet():
        with g.quiet():
            got.set()
            assert not resumed.wait(0.2)

    te = _thread(engine)
    assert idle.wait(10)
    assert g.launchers() == 0
    tq = _thread(quiet)
    assert got.wait(10)
    wake.set()
    tq.join(10)
    te.join(10)
    assert resumed.is_set() and g.launchers() == 0


def test_a_launching_thread_cannot_wait_for_a_quiet_point():
    from gofr_tpu_torch.gpu.launch_gate import LaunchGate

    g = LaunchGate()
    with g.launching(), pytest.raises(RuntimeError, match="cannot wait for a quiet point"):
        with g.quiet():
            pass
    assert g.launchers() == 0
    with g.quiet():
        assert g.launchers() == 0


def test_quiet_profile_records_and_leaves_the_gate_open():
    from torch.profiler import ProfilerActivity

    from gofr_tpu_torch.gpu.launch_gate import LAUNCH_GATE, quiet_profile

    with quiet_profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).add_(1)
    assert any("add_" in e.key for e in prof.key_averages())
    with LAUNCH_GATE.launching():
        assert LAUNCH_GATE.launchers() == 1
    assert LAUNCH_GATE.launchers() == 0


def test_a_generate_engine_turn_waits_for_a_quiet_point_and_idles_outside_the_gate():
    """An idle engine holds the gate only between its idle waits; a
    request submitted during a quiet point is served only after it, with
    the tokens the engine gave it before."""
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.gpu.launch_gate import LAUNCH_GATE

    eng = build_engine("tiny", device="cpu", seed=0, slots=2, max_len=64)
    try:
        want = eng.generate([1, 2, 3, 4], max_new_tokens=4, timeout=60)["tokens"]
        # idle, the device thread spends its turns in the paused wait
        held = []
        for _ in range(20):
            held.append(LAUNCH_GATE.launchers())
            time.sleep(0.01)
        assert held.count(0) >= 10, f"an idle engine held the gate: {held}"
        with LAUNCH_GATE.quiet():
            done = threading.Event()
            req = eng.submit([1, 2, 3, 4], max_new_tokens=4)
            req.add_done_callback(lambda r: done.set())
            assert not done.wait(0.5), "the engine served a request during a quiet point"
        assert req.result(timeout=60)["tokens"] == want
    finally:
        eng.stop()


def test_a_batch_engine_step_waits_for_a_quiet_point():
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.gpu.launch_gate import LAUNCH_GATE
    from gofr_tpu_torch.models import BertConfig, ModelSpec

    spec = ModelSpec("bert", BertConfig.tiny(vocab_size=300), task="embed", dtype=torch.float32)
    eng = build_engine(spec, new_mock_container(), device="cpu")
    try:
        want = eng.infer([5, 6, 7], timeout=60)
        with LAUNCH_GATE.quiet():
            out: list = []
            t = _thread(lambda: out.append(eng.infer([5, 6, 7], timeout=60)))
            time.sleep(0.5)
            assert not out, "the batch engine stepped during a quiet point"
        t.join(60)
        assert len(out) == 1 and torch.equal(torch.as_tensor(out[0]), torch.as_tensor(want))
    finally:
        eng.stop()
