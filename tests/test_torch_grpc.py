"""The port App's gRPC entry point (gofr_tpu_torch/grpc/server.py) held
against the JAX App's.

Both serving examples run on the same tiny f32 weights (the port's on the
JAX engine's, ``params_from_jax``) with a JSON-over-gRPC ``gen.Gen``
service registered as examples/grpc-server registers its own: unary
``Generate`` and server-streaming ``GenerateStream``, each calling
``current_grpc_context().generate``. The same calls give the same tokens
and pieces and the same status codes: a handler error is ``INTERNAL``, a
429 under QoS is ``RESOURCE_EXHAUSTED`` (with ``retry-after``), and a
deadline the request cannot meet is ``DEADLINE_EXCEEDED``. Tolerances:
exact.
"""

import importlib.util
import json
import os
import threading

import jax
import numpy as np
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")
grpc = pytest.importorskip("grpc")

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
SERVICE = "gen.Gen"


def _load(name: str):
    path = os.path.join(EXAMPLES, name, "main.py")
    spec = importlib.util.spec_from_file_location(f"example_grpc_{name.replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def add_gen_service(current):
    """An ``add_*_to_server`` for a JSON-over-gRPC generate service whose
    methods reach the engine through ``current()``, the package's
    ``current_grpc_context``."""
    def generate(request, context):
        if request.get("boom"):
            raise RuntimeError("servicer fault")
        out = current().generate("lm", request["prompt"], max_new_tokens=request.get("n", 6))
        return {"tokens": out["tokens"], "text": out.get("text"),
                "finish_reason": out["finish_reason"]}

    def generate_stream(request, context):
        for piece in current().generate("lm", request["prompt"],
                                        max_new_tokens=request.get("n", 6), stream=True):
            yield {"piece": piece}

    def add(server):
        codec = dict(request_deserializer=lambda b: json.loads(b.decode() or "{}"),
                     response_serializer=lambda o: json.dumps(o).encode())
        server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, {
            "Generate": grpc.unary_unary_rpc_method_handler(generate, **codec),
            "GenerateStream": grpc.unary_stream_rpc_method_handler(generate_stream, **codec),
        }),))

    return add


def _build(qos: bool = False):
    """The JAX example and the port's, each with the service; the port's on
    the JAX weights and ``GRPC_PORT`` 0 (it reads the bound port back)."""
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.grpc.server import current_grpc_context as jax_current
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.grpc.server import current_grpc_context

    def conf(grpc_port):
        return {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()),
                "GRPC_PORT": grpc_port}

    japp = _load("serving-llm").build_app(JaxConfig(conf(str(_free_port()))))
    params = jax.tree.map(np.asarray, japp.container.engines["lm"].params)
    papp = _load("serving-llm-torch").build_app(DictConfig(conf("0")), params=params, device="cpu")
    for app, current in ((japp, jax_current), (papp, current_grpc_context)):
        app.register_grpc_service(add_gen_service(current))
        if qos:
            app.enable_qos(rate_rps=0.01, rate_burst=1)
    return japp, papp


def _call(app, method: str, body: dict, *, stream: bool = False, timeout: float = 120):
    """(status name, reply or pieces, retry-after) of one call."""
    with grpc.insecure_channel(f"127.0.0.1:{app.grpc_port}") as ch:
        path = f"/{SERVICE}/{method}"
        ser = dict(request_serializer=lambda o: json.dumps(o).encode(),
                   response_deserializer=lambda b: json.loads(b.decode()))
        try:
            if stream:
                reply = [m["piece"] for m in ch.unary_stream(path, **ser)(body, timeout=timeout)]
                return "OK", reply, None
            reply, call = ch.unary_unary(path, **ser).with_call(body, timeout=timeout)
            return "OK", reply, None
        except grpc.RpcError as e:
            retry = dict(e.trailing_metadata() or ()).get("retry-after")
            return e.code().name, None, retry is not None


@pytest.mark.quick
def test_generate_and_stream_equal_the_jax_app():
    """Unary calls at once from threads, one stream and a servicer fault:
    the same replies and codes from both Apps; the port App bound a free
    port for ``GRPC_PORT`` 0 and stops its server with the App."""
    got = []
    apps = _build()
    for app in apps:
        with AppHarness(app):
            assert app.grpc_port > 0
            bodies = [{"prompt": [1, 2, 3]}, {"prompt": "grpc hello", "n": 5},
                      {"prompt": [9, 8, 7, 6], "n": 4}]
            replies = [None] * len(bodies)

            def one(i):
                replies[i] = _call(app, "Generate", bodies[i])

            threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(300)
            stream = _call(app, "GenerateStream", {"prompt": "grpc hello", "n": 5}, stream=True)
            fault = _call(app, "Generate", {"prompt": [1], "boom": True})
            got.append((replies, stream, fault))
    assert got[0] == got[1]
    replies, stream, fault = got[1]
    assert all(r[0] == "OK" and r[1]["finish_reason"] == "length" for r in replies)
    assert [len(r[1]["tokens"]) for r in replies] == [6, 5, 4]
    assert stream[0] == "OK" and "".join(stream[1]) == replies[1][1]["text"]
    assert fault[0] == "INTERNAL"
    port_app = apps[1]
    assert not any(t.name.startswith("gofr-grpc") and t.is_alive()
                   for t in threading.enumerate()), "gRPC pool threads outlived the App"
    assert port_app.grpc_port > 0


@pytest.mark.quick
def test_qos_and_deadline_codes_equal_the_jax_app():
    """Under a 1-request burst the second call is refused before the
    servicer, ``RESOURCE_EXHAUSTED`` with ``retry-after``; a deadline too
    short for the generation is ``DEADLINE_EXCEEDED``."""
    got = []
    for app in _build(qos=True):
        with AppHarness(app):
            first = _call(app, "Generate", {"prompt": [1, 2, 3], "n": 2})
            second = _call(app, "Generate", {"prompt": [1, 2, 3], "n": 2})
            got.append((first[0], second))
    assert got[0] == got[1] == ("OK", ("RESOURCE_EXHAUSTED", None, True))
    got = []
    for app in _build():
        with AppHarness(app):
            got.append(_call(app, "Generate", {"prompt": [1, 2, 3], "n": 60}, timeout=0.02)[0])
    assert got[0] == got[1] == "DEADLINE_EXCEEDED"


@pytest.mark.quick
def test_grpc_imports_only_where_it_serves():
    """The App and the gRPC module import without touching ``grpc``; the
    interceptors map the typed errors as JAX's do."""
    import ast
    import pathlib

    from gofr_tpu.grpc.server import _grpc_code_of as jax_code
    from gofr_tpu_torch.grpc.server import _grpc_code_of

    root = pathlib.Path(__file__).resolve().parents[1] / "gofr_tpu_torch"
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in tree.body:  # module level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in ("grpc", "cryptography") for n in names), path

    class E(Exception):
        def __init__(self, code):
            self.status_code = code

    for code in (429, 503, 504, 408, 500, None):
        assert _grpc_code_of(E(code)) == jax_code(E(code))
