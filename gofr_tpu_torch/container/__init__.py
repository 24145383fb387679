"""Container: the dependency-injection hub (gofr `pkg/gofr/container/
container.go`), the port's own copy of gofr_tpu/container/__init__.py
reduced to what serving needs: config, logger, metrics and the model
engines, their health and their shutdown.

Datasources, pub/sub, inter-service clients, the tracer, the flight
recorder and the QoS, SLO and perf planes are not ported yet; ``health``
reports the engines alone.
"""

from __future__ import annotations

from typing import Any

import gofr_tpu_torch
from gofr_tpu_torch.config import DictConfig
from gofr_tpu_torch.logging import Level, Logger, MockLogger, new_logger
from gofr_tpu_torch.metrics import Registry, sample_runtime_metrics


class Container:
    def __init__(self, config, logger: Logger | None = None):
        self.config = config
        self.app_name = config.get_or_default("APP_NAME", "gofr-tpu-app")
        self.app_version = config.get_or_default("APP_VERSION", "dev")
        self.logger: Logger = logger or new_logger(config.get_or_default("LOG_LEVEL", "INFO"))
        self.metrics: Registry = Registry(logger=self.logger)
        self._engines: dict[str, Any] = {}

    @classmethod
    def create(cls, config) -> "Container":
        c = cls(config)
        c._register_framework_metrics()
        c.metrics.add_collect_hook(sample_runtime_metrics)
        return c

    def _register_framework_metrics(self) -> None:
        m = self.metrics
        g = m.new_gauge("app_info", "application info")
        g.set(1, app=self.app_name, version=self.app_version,
              framework=f"gofr_tpu_torch-{gofr_tpu_torch.__version__}")
        m.new_histogram("app_http_response", "HTTP handler latency (s)")

    # -- model engines ---------------------------------------------------------

    def register_engine(self, name: str, engine: Any) -> None:
        self._engines[name] = engine

    def engine(self, name: str):
        try:
            return self._engines[name]
        except KeyError:
            raise KeyError(
                f"no model {name!r} served; registered: {sorted(self._engines)}"
            ) from None

    @property
    def engines(self) -> dict[str, Any]:
        return dict(self._engines)

    def infer(self, model: str, inputs: Any, **kw: Any):
        return self.engine(model).infer(inputs, **kw)

    def generate(self, model: str, prompt: Any, **kw: Any):
        return self.engine(model).generate(prompt, **kw)

    # -- health aggregation (gofr `container/health.go`) -----------------------

    def health(self) -> dict[str, Any]:
        services: dict[str, Any] = {}
        down = 0
        for name, engine in self._engines.items():
            try:
                h = engine.health_check() if hasattr(engine, "health_check") else {"status": "UP"}
            except Exception as e:  # noqa: BLE001
                h = {"status": "DOWN", "details": {"error": str(e)}}
            services[f"model:{name}"] = h
            if h.get("status") != "UP":
                down += 1
        status = "UP" if down == 0 else ("DEGRADED" if down < max(len(services), 1) else "DOWN")
        return {
            "status": status,
            "name": self.app_name,
            "version": self.app_version,
            "services": services,
        }

    # -- shutdown --------------------------------------------------------------

    def close(self) -> None:
        for engine in self._engines.values():
            if hasattr(engine, "stop"):
                engine.stop()


def new_mock_container(config: dict[str, str] | None = None) -> Container:
    """Hermetic container for handler tests (gofr `NewMockContainer`): mock
    logger, real metrics registry."""
    c = Container(DictConfig(config or {}), logger=MockLogger(level=Level.DEBUG))
    c._register_framework_metrics()
    return c
