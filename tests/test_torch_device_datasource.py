"""The card as a datasource on the port (``gpu.device.GPUDevices``,
``container.tpu`` / ``ctx.tpu``), held to tests/test_tpu_device.py's cases
on the CPU: the device count and its cap, the mesh (one device; a mesh
over more than one is refused, where JAX builds it), the health check's
shape against ``TPUDevices``'s, the count gauge, the lazy wiring, the
memory gauges pushed on a scrape through the datasource, and
``build_engine`` wiring it.

The card is stood in for, where a case needs one, by patching the
``torch.cuda`` calls the datasource makes (``device_count``,
``get_device_name``, ``mem_get_info``) and ``resolve_device``; every
number the gauges carry then comes from the patched ``mem_get_info``.
"""

import pytest

torch = pytest.importorskip("torch")


def _registry():
    from gofr_tpu_torch.container import new_mock_container

    return new_mock_container().metrics


def make(conf=None, reg=None, device="cpu"):
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.gpu.device import GPUDevices
    from gofr_tpu_torch.logging import MockLogger

    return GPUDevices(DictConfig(conf or {}), MockLogger(), reg or _registry(), device=device)


@pytest.fixture
def fake_cards(monkeypatch):
    """Two cards of 80 GB for the datasource, each reporting the memory
    ``used[i]`` in use (mutable: a test moves it between scrapes)."""
    from gofr_tpu_torch.gpu import device as device_mod

    used = {0: 1 << 30, 1: 2 << 30}
    total = 80 << 30

    def mem_get_info(d):
        i = torch.device(d).index or 0
        return total - used[i], total

    monkeypatch.setattr(device_mod, "resolve_device",
                        lambda device=None: torch.device("cuda" if device is None else device))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "Fake H100")
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    return used, total


@pytest.mark.quick
def test_defaults_one_device_on_dp():
    t = make()
    assert len(t.devices) == 1 and t.devices[0].type == "cpu"
    assert t.mesh == {"dp": 1} and t.platform == "cpu"


def test_a_mesh_over_more_than_one_device_is_refused(fake_cards):
    """tests/test_tpu_device.py's mesh case: JAX builds ``dp:2,tp:4`` over
    its 8 devices; the port serves on one card and refuses any mesh over
    more, naming the queue item that brings sharding."""
    for mesh in ("dp:2", "tp:-1", "dp:1,tp:2"):
        with pytest.raises(RuntimeError, match="Queue A 9"):
            make({"TPU_MESH": mesh}, device=None)
    assert make({"TPU_MESH": "tp:1"}, device=None).mesh == {"tp": 1}
    assert make({"TPU_MESH": "dp:-1", "TPU_DEVICES": "1"}, device=None).mesh == {"dp": 1}
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make({"TPU_MESH": "xx:1"})


def test_device_cap(fake_cards):
    """Of two visible cards the datasource counts the one it serves on
    (``cuda`` resolves to the current card), under ``TPU_DEVICES`` too;
    the other card is never read."""
    assert make(device=None).devices == [torch.device("cuda", 0)]
    assert make({"TPU_DEVICES": "1"}, device=None).devices == [torch.device("cuda", 0)]
    assert make(device="cuda:1").devices == [torch.device("cuda", 1)]


def test_health_check_up_in_the_jax_shape():
    """Details as ``TPUDevices.health_check`` gives them (platform,
    devices, mesh, memory by device with bytes in use and limit), and the
    card's name besides."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu.logging import MockLogger as JaxLogger
    from gofr_tpu.tpu.device import TPUDevices

    want = TPUDevices(JaxConfig({}), JaxLogger(), jax_container().metrics).health_check()
    h = make().health_check()
    assert h["status"] == want["status"] == "UP"
    assert set(h["details"]) == set(want["details"]) | {"name"}
    assert h["details"]["devices"] == 1 and h["details"]["mesh"] == {"dp": 1}
    mem = next(iter(want["details"]["memory"].values()))
    assert h["details"]["memory"] == {"0": {k: 0 for k in mem}}


def test_the_card_s_health_and_memory(fake_cards):
    used, total = fake_cards
    h = make(device=None).health_check()
    assert h["details"]["platform"] == "gpu" and h["details"]["name"] == "Fake H100"
    assert h["details"]["memory"] == {"0": {"bytes_in_use": used[0], "bytes_limit": total}}
    assert make(device="cuda:1").health_check()["details"]["memory"] == {
        "1": {"bytes_in_use": used[1], "bytes_limit": total}}
    t = make(device=None)
    t.devices = []
    assert t.health_check()["status"] == "DOWN"


def test_device_count_gauge(fake_cards):
    reg = _registry()
    make(reg=reg)
    assert reg.get("app_tpu_device_count").value() == 1
    make({"TPU_DEVICES": "1"}, reg=reg, device=None)
    assert reg.get("app_tpu_device_count").value() == 1
    make(reg=reg, device=None)
    assert reg.get("app_tpu_device_count").value() == 1


@pytest.mark.quick
def test_container_lazily_wires_tpu():
    from gofr_tpu_torch.container import new_mock_container

    c = new_mock_container()
    assert not c.tpu_wired and "tpu" not in c.health()["services"]
    tpu = c.wire_tpu("cpu")
    assert c.tpu_wired and tpu is c.tpu and tpu is c.wire_tpu("cuda")
    assert c.health()["services"]["tpu"]["status"] == "UP"


def test_ctx_tpu_without_a_card_raises():
    """``ctx.tpu`` on a container whose datasource no engine build wired on
    the CPU: the card, or ``resolve_device``'s error, never a CPU
    datasource."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.context import Context

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    c = new_mock_container()
    ctx = Context(None, c)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ctx.tpu
    assert not c.tpu_wired
    c.wire_tpu("cpu")
    assert ctx.tpu.platform == "cpu"


def test_scrape_pushes_the_memory_gauges_through_the_datasource(fake_cards):
    """The one place the card's memory is read: each ``/metrics`` scrape
    pushes ``app_tpu_hbm_*`` from the datasource's ``mem_get_info``, the
    values of that moment; before the datasource is wired a scrape reads
    no device."""
    from gofr_tpu_torch.container import new_mock_container

    used, total = fake_cards
    c = new_mock_container()
    text = c.metrics.expose_text()
    assert "app_tpu_hbm_used_bytes{" not in text and not c.tpu_wired
    c.tpu
    used[0] = 5 << 30
    lines = c.metrics.expose_text().splitlines()
    got = {(line.split("{")[0], line.split('"')[1]): float(line.rsplit(" ", 1)[1])
           for line in lines if line.startswith("app_tpu_hbm_")}
    assert got == {("app_tpu_hbm_used_bytes", "0"): 5 << 30,
                   ("app_tpu_hbm_limit_bytes", "0"): total}
    used[0] = 7 << 30
    h = c.health()["services"]["tpu"]["details"]["memory"]
    assert h == {"0": {"bytes_in_use": 7 << 30, "bytes_limit": total}}
    assert c.metrics.get("app_tpu_hbm_used_bytes").value(device="0") == 7 << 30


def test_build_engine_serves_on_the_container_s_device():
    """``build_engine(spec, container, device=...)`` wires the engine's
    device as the container's datasource, for a generate and a batch
    engine alike; without a card and without a device the build raises
    ``resolve_device``'s error and wires nothing."""
    from gofr_tpu_torch.container import new_mock_container
    from gofr_tpu_torch.gpu.engine import build_engine
    from gofr_tpu_torch.models import BertConfig, ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    spec = ModelSpec("llama", LlamaConfig.tiny(), dtype=torch.float32)
    c = new_mock_container()
    eng = build_engine(spec, c, device="cpu", slots=2, max_len=32)
    try:
        assert eng.device.type == "cpu" and c.tpu_wired and c.tpu.device == eng.device
    finally:
        eng.stop()
    c2 = new_mock_container()
    eng = build_engine(ModelSpec("bert", BertConfig.tiny(), task="embed", dtype=torch.float32),
                       c2, device="cpu")
    try:
        assert c2.tpu_wired and c2.tpu.device == eng.device
    finally:
        eng.stop()
    if not torch.cuda.is_available():
        c3 = new_mock_container()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_engine(spec, c3, slots=2, max_len=32)
        assert not c3.tpu_wired


def test_an_engine_built_on_a_named_device_exports_the_gauges_on_a_scrape():
    """The App's route with an explicit device (``serve_model(spec,
    device=...)``): the build wires the datasource, so each ``/metrics``
    scrape carries ``app_tpu_device_count`` and ``app_tpu_hbm_*`` for the
    engine's device (zeros on the CPU)."""
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.models import ModelSpec
    from gofr_tpu_torch.models.llama import LlamaConfig

    app = App(config=DictConfig({"LOG_LEVEL": "ERROR"}))
    try:
        app.serve_model("lm", ModelSpec("llama", LlamaConfig.tiny(), dtype=torch.float32),
                        device="cpu", slots=2, max_len=32)
        lines = app.container.metrics.expose_text().splitlines()
        assert "app_tpu_device_count 1" in lines or "app_tpu_device_count 1.0" in lines
        assert {line.split(" ")[0] for line in lines if line.startswith("app_tpu_hbm_")} == {
            'app_tpu_hbm_used_bytes{device="0"}', 'app_tpu_hbm_limit_bytes{device="0"}'}
    finally:
        app.container.close()
