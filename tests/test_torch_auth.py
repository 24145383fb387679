"""The port App's auth middlewares, static files and OpenAPI routes held
against the JAX App's on the same requests, and the port's JWT
verification against tests/test_auth_jwt.py's cases.

Each case sends the same requests to a JAX App and a port App (mock
containers, the same config) and holds the statuses and bodies equal:
Basic and API-key auth with static maps and container-aware validators,
``/.well-known/*`` skipped, HS256 and RS256 bearer tokens (RS256 keys from
a local JWKS endpoint, rotated), the verified identity in the handler's
context; a static mount with its traversal guard and ``openapi.json``
refusal; the generated spec and the offline docs page
(tests/test_http_server.py :138, :210, :521). Tolerances: exact.
"""

import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import httpx
import pytest

from tests.test_http_server import AppHarness, _free_port

torch = pytest.importorskip("torch")


def _apps(config=None):
    from gofr_tpu import app as jax_app
    from gofr_tpu.config import DictConfig as JaxConfig
    from gofr_tpu.container import new_mock_container as jax_container
    from gofr_tpu_torch.app import App
    from gofr_tpu_torch.config import DictConfig
    from gofr_tpu_torch.container import new_mock_container

    out = []
    for app_cls, conf_cls, cont in ((jax_app.App, JaxConfig, jax_container),
                                    (App, DictConfig, new_mock_container)):
        conf = {"HTTP_PORT": str(_free_port()), "METRICS_PORT": str(_free_port()),
                **(config or {})}
        out.append(app_cls(config=conf_cls(conf), container=cont(conf)))
    return out


def _both(setup, requests, config=None):
    """Run ``requests(client)`` against a JAX App and a port App, each set
    up by ``setup(app)``; return both results."""
    got = []
    for app in _apps(config):
        setup(app)
        with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
            got.append(requests(c))
    return got


def _reply(r: httpx.Response):
    try:
        body = r.json()
    except ValueError:
        body = r.text
    return r.status_code, body


def _who(ctx):
    return {"user": ctx.auth_user, "claims": ctx.claims}


@pytest.mark.quick
def test_basic_auth_equals_the_jax_app():
    def setup(app):
        app.enable_basic_auth({"admin": "secret"})
        app.get("/private", _who)

    def requests(c):
        return [_reply(c.get("/private")), _reply(c.get("/private", auth=("admin", "secret"))),
                _reply(c.get("/private", auth=("admin", "wrong"))),
                _reply(c.get("/private", headers={"Authorization": "Basic !!notb64"})),
                _reply(c.get("/private", headers={"Authorization": "Bearer x"})),
                _reply(c.get("/.well-known/alive")), _reply(c.get("/no/such"))]

    jax_got, port_got = _both(setup, requests)
    assert port_got == jax_got
    assert [s for s, _ in port_got] == [401, 200, 401, 401, 401, 200, 401]
    assert port_got[1][1] == {"data": {"user": "admin", "claims": {}}}


@pytest.mark.quick
def test_api_key_and_validators_equal_the_jax_app():
    """A static key set and container-aware validators (the validator gets
    the container first), for both schemes."""
    def setup(app):
        app.enable_api_key_auth("k1", "k2")
        app.get("/k", _who)

    def requests(c):
        return [_reply(c.get("/k")), _reply(c.get("/k", headers={"X-API-KEY": "k2"})),
                _reply(c.get("/k", headers={"X-API-KEY": "nope"}))]

    jax_got, port_got = _both(setup, requests)
    assert port_got == jax_got and [s for s, _ in port_got] == [401, 200, 401]

    seen = []

    def setup_v(app):
        app.enable_basic_auth_with_validator(
            lambda container, u, p: seen.append(container is app.container) or p == u[::-1])
        app.get("/v", _who)

    def requests_v(c):
        return [_reply(c.get("/v", auth=("abc", "cba"))), _reply(c.get("/v", auth=("abc", "abc")))]

    jax_got, port_got = _both(setup_v, requests_v)
    assert port_got == jax_got and [s for s, _ in port_got] == [200, 401]
    assert seen and all(seen)

    def setup_k(app):
        app.enable_api_key_auth_with_validator(lambda container, key: key.startswith("ok-"))
        app.get("/v", _who)

    def requests_k(c):
        return [_reply(c.get("/v", headers={"X-API-KEY": "ok-1"})),
                _reply(c.get("/v", headers={"X-API-KEY": "bad"}))]

    jax_got, port_got = _both(setup_k, requests_k)
    assert port_got == jax_got and [s for s, _ in port_got] == [200, 401]


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def make_hs256(secret: bytes, claims: dict) -> str:
    import hashlib
    import hmac

    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    payload = _b64url(json.dumps(claims).encode())
    sig = hmac.new(secret, f"{header}.{payload}".encode(), hashlib.sha256).digest()
    return f"{header}.{payload}.{_b64url(sig)}"


def make_rs256(private_key, claims: dict, kid: str = "k1") -> str:
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.asymmetric import padding

    header = _b64url(json.dumps({"alg": "RS256", "typ": "JWT", "kid": kid}).encode())
    payload = _b64url(json.dumps(claims).encode())
    sig = private_key.sign(f"{header}.{payload}".encode(), padding.PKCS1v15(), hashes.SHA256())
    return f"{header}.{payload}.{_b64url(sig)}"


def _jwk(key, kid):
    pub = key.public_key().public_numbers()

    def int_b64(n):
        return _b64url(n.to_bytes((n.bit_length() + 7) // 8, "big"))

    return {"kty": "RSA", "kid": kid, "n": int_b64(pub.n), "e": int_b64(pub.e)}


@pytest.fixture(scope="module")
def rsa_keys():
    from cryptography.hazmat.primitives.asymmetric import rsa

    return [rsa.generate_private_key(public_exponent=65537, key_size=2048) for _ in range(2)]


@pytest.fixture
def jwks(rsa_keys):
    """A local JWKS endpoint whose key set the test can rotate or break."""
    box = {"jwks": {"keys": [_jwk(rsa_keys[0], "kid-a")]}}

    class H(BaseHTTPRequestHandler):
        def do_GET(self):
            if box.get("fail"):
                self.send_response(500)
                self.end_headers()
                return
            body = json.dumps(box["jwks"]).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), H)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    box["url"] = f"http://127.0.0.1:{srv.server_address[1]}/jwks"
    yield box
    srv.shutdown()
    t.join(5)


@pytest.mark.quick
def test_hs256_bearer_tokens_equal_the_jax_app():
    now = time.time()
    tokens = {"good": make_hs256(b"s3cret", {"sub": "svc", "aud": "api", "exp": now + 300}),
              "wrong_secret": make_hs256(b"other", {"sub": "svc", "aud": "api"}),
              "expired": make_hs256(b"s3cret", {"sub": "svc", "aud": "api", "exp": now - 600}),
              "audience": make_hs256(b"s3cret", {"sub": "svc", "aud": "web"}),
              "malformed": "a.b"}

    def setup(app):
        app.enable_jwt_hs256("s3cret", audience="api")
        app.get("/j", _who)

    def requests(c):
        out = [_reply(c.get("/j"))]
        for tok in tokens.values():
            out.append(_reply(c.get("/j", headers={"Authorization": f"Bearer {tok}"})))
        return out

    jax_got, port_got = _both(setup, requests)
    assert port_got == jax_got
    assert [s for s, _ in port_got] == [401, 200, 401, 401, 401, 401]
    assert port_got[1][1]["data"]["user"] == "svc"
    assert port_got[1][1]["data"]["claims"]["aud"] == "api"


@pytest.mark.quick
def test_rs256_through_jwks_with_rotation_equals_the_jax_app(rsa_keys, jwks):
    """A token of the published key verifies, one of an unpublished key
    does not; after the endpoint rotates (and a refresh), the reverse; a
    failing endpoint keeps the last good keys. ``stop`` ends the poller."""
    tok_a = make_rs256(rsa_keys[0], {"sub": "alice"}, kid="kid-a")
    tok_b = make_rs256(rsa_keys[1], {"sub": "bob"}, kid="kid-b")
    got = []
    for app in _apps():
        jwks["jwks"] = {"keys": [_jwk(rsa_keys[0], "kid-a")]}
        jwks.pop("fail", None)
        app.enable_oauth(jwks["url"], refresh_interval=0.2)
        app.get("/r", _who)
        with AppHarness(app) as h, httpx.Client(base_url=h.base, timeout=30) as c:
            def call(tok):
                return _reply(c.get("/r", headers={"Authorization": f"Bearer {tok}"}))

            out = [call(tok_a), call(tok_b)]
            jwks["jwks"] = {"keys": [_jwk(rsa_keys[1], "kid-b")]}
            time.sleep(1.0)  # the poller refreshes every 0.2 s
            out += [call(tok_a), call(tok_b)]
            jwks["fail"] = True
            time.sleep(1.0)
            out.append(call(tok_b))
        got.append(out)
    assert got[0] == got[1]
    assert [s for s, _ in got[1]] == [200, 401, 401, 200, 200]
    assert got[1][0][1]["data"]["user"] == "alice"
    # the port App's stop ended its poller
    assert all(not p._thread.is_alive() for p in app._jwks)


@pytest.mark.quick
def test_verify_jwt_cases_of_the_jax_suite(rsa_keys, jwks):
    """tests/test_auth_jwt.py's verification cases, on the port's
    ``verify_jwt`` beside JAX's: the same claims or the same error."""
    from gofr_tpu.http.middleware.auth import JWKSCache as JaxJWKS, verify_jwt as jax_verify
    from gofr_tpu_torch.http.middleware.auth import JWKSCache, verify_jwt

    header = _b64url(json.dumps({"alg": "none"}).encode())
    payload = _b64url(json.dumps({"sub": "x"}).encode())
    good = make_rs256(rsa_keys[0], {"sub": "a", "aud": "api", "iss": "me"}, kid="kid-a")
    cases = [
        (good, {}), (good[:-6] + "aaaaaa", {}),
        (make_rs256(rsa_keys[0], {"sub": "a", "exp": time.time() - 600}, kid="kid-a"), {}),
        (good, {"audience": "api", "issuer": "me"}), (good, {"audience": "other"}),
        (good, {"issuer": "them"}),
        (make_hs256(b"secret", {"sub": "svc"}), {"hs_secret": b"secret"}),
        (make_hs256(b"secret", {"sub": "svc"}), {"hs_secret": b"wrong"}),
        ("", {"hs_secret": b"s"}), ("a.b.c.d", {"hs_secret": b"s"}),
        ("!!!.@@@.###", {"hs_secret": b"s"}), (f"{header}.{payload}.", {"hs_secret": b"s"}),
        (make_rs256(rsa_keys[1], {"sub": "b"}, kid="kid-b"), {}),
    ]
    outs = []
    for cache_cls, verify in ((JaxJWKS, jax_verify), (JWKSCache, verify_jwt)):
        cache = cache_cls(jwks["url"])
        cache.refresh()
        out = []
        for tok, kw in cases:
            try:
                out.append(("ok", verify(tok, jwks=cache, **kw)))
            except ValueError as e:
                out.append(("err", str(e)))
        outs.append(out)
    assert outs[0] == outs[1]
    assert [k for k, _ in outs[1]] == ["ok", "err", "err", "ok", "err", "err", "ok", "err",
                                       "err", "err", "err", "err", "err"]


@pytest.mark.quick
def test_auth_runs_after_qos_as_in_jax():
    """A request over the rate limit is refused 429 before auth looks at
    it, so shed load never pays the auth path; an authorised one within
    it passes."""
    def setup(app):
        app.enable_qos(rate_rps=0.01, rate_burst=1)
        app.enable_basic_auth({"u": "p"})
        app.get("/q", _who)

    def requests(c):
        return [_reply(c.get("/q", auth=("u", "p")))[0], _reply(c.get("/q"))[0]]

    jax_got, port_got = _both(setup, requests)
    assert port_got == jax_got == [200, 429]


# -- static files and OpenAPI ----------------------------------------------------


@pytest.mark.quick
def test_static_files_served_but_openapi_forbidden_as_in_jax(tmp_path):
    (tmp_path / "index.html").write_text("<h1>hi</h1>")
    (tmp_path / "openapi.json").write_text("{}")
    sub = tmp_path / "sub"
    sub.mkdir()
    (sub / "openapi.json").write_text("{}")
    (sub / "ok.txt").write_text("fine")
    (tmp_path.parent / "outside-secret.txt").write_text("secret")

    def setup(app):
        app.add_static_files("/static", str(tmp_path))

    def requests(c):
        out = []
        for path in ("/static/index.html", "/static/sub/ok.txt", "/static/openapi.json",
                     "/static/sub/openapi.json", "/static/missing.txt",
                     "/static/%2E%2E/outside-secret.txt", "/static/"):
            r = c.get(path)
            out.append((r.status_code, r.text if r.status_code == 200 else r.json(),
                        r.headers.get("content-type", "").split(";")[0]))
        return out

    jax_got, port_got = _both(setup, requests)
    assert port_got == jax_got
    assert [s for s, *_ in port_got] == [200, 200, 403, 403, 404, 404, 404]
    assert port_got[0][1] == "<h1>hi</h1>" and port_got[0][2] == "text/html"
    assert "well-known" in port_got[2][1]["error"]["message"]


@pytest.mark.quick
def test_openapi_spec_and_offline_docs_equal_the_jax_app():
    def setup(app):
        app.get("/greet", lambda ctx: "hi")
        app.post("/things/{id}", lambda ctx: {"ok": True})

    def requests(c):
        docs = c.get("/.well-known/swagger")
        return [_reply(c.get("/.well-known/openapi.json")), docs.status_code,
                "unpkg.com" in docs.text or "https://" in docs.text,
                "/.well-known/openapi.json" in docs.text]

    jax_got, port_got = _both(setup, requests)
    assert port_got == jax_got
    spec = port_got[0][1]
    assert "/greet" in spec["paths"] and "post" in spec["paths"]["/things/{id}"]
    assert port_got[1:] == [200, False, True]

    def cdn(c):
        return "unpkg.com" in c.get("/.well-known/swagger").text

    assert _both(setup, cdn, {"SWAGGER_UI": "cdn"}) == [True, True]
