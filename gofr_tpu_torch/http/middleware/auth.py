"""Auth middlewares: Basic, API-key, and OAuth2/JWT with background-refreshed JWKS.

Parity with gofr `pkg/gofr/http/middleware/{basic_auth,apikey_auth,oauth}.go`:
static credential maps or custom validators (container-aware), ``/.well-known/*``
always skipped (`basic_auth.go:25-29`), JWKS polled on a ticker with RSA keys
reconstructed from the JWK ``n``/``e`` members (`oauth.go:53-71,187-207`), and
verified claims injected into the request context (`oauth.go:147-148`).

JWT verification (RS256 via `cryptography`, HS256 via stdlib hmac) is
implemented in-tree — no PyJWT dependency.

The port's own copy of gofr_tpu/http/middleware/auth.py, written against
``http/server.py``'s middleware signature: the verified identity goes to
``request.state[AUTH_KEY]``, which the App copies into the request context.
``cryptography`` is imported only where a key is built or checked.
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import threading
import time
import urllib.request
from typing import Any, Callable

from gofr_tpu_torch.http.server import ServerRequest, ServerResponse

WELL_KNOWN_PREFIX = "/.well-known/"
# ``ServerRequest.state`` key of the verified identity (JAX's request key)
AUTH_KEY = "gofr_auth"


def _unauthorized(message: str = "unauthorized") -> ServerResponse:
    return ServerResponse(401, json.dumps({"error": {"message": message}}).encode())


def _b64url_decode(data: str) -> bytes:
    data += "=" * (-len(data) % 4)
    return base64.urlsafe_b64decode(data)


# -- Basic auth ----------------------------------------------------------------


def basic_auth_middleware(users: dict[str, str] | None = None,
                          validator: Callable[..., bool] | None = None,
                          container=None):
    async def mw(request: ServerRequest, handler):
        if request.path.startswith(WELL_KNOWN_PREFIX):
            return await handler(request)
        header = request.headers.get("authorization", "")
        if not header.startswith("Basic "):
            return _unauthorized()
        try:
            decoded = base64.b64decode(header[6:]).decode()
            username, _, password = decoded.partition(":")
        except Exception:  # noqa: BLE001
            return _unauthorized()
        if validator is not None:
            ok = validator(container, username, password) if container is not None else validator(username, password)
            if not ok:
                return _unauthorized()
        elif users is None or users.get(username) != password:
            return _unauthorized()
        request.state[AUTH_KEY] = {"auth_user": username, "auth_method": "basic"}
        return await handler(request)

    return mw


# -- API key auth --------------------------------------------------------------


def apikey_auth_middleware(keys: list[str] | None = None,
                           validator: Callable[..., bool] | None = None,
                           container=None):
    keyset = set(keys or [])

    async def mw(request: ServerRequest, handler):
        if request.path.startswith(WELL_KNOWN_PREFIX):
            return await handler(request)
        key = request.headers.get("x-api-key", "")
        if not key:
            return _unauthorized()
        if validator is not None:
            ok = validator(container, key) if container is not None else validator(key)
            if not ok:
                return _unauthorized()
        elif key not in keyset:
            return _unauthorized()
        request.state[AUTH_KEY] = {"auth_user": "api-key", "auth_method": "apikey"}
        return await handler(request)

    return mw


# -- OAuth / JWT ---------------------------------------------------------------


class JWKSCache:
    """Fetches a JWKS endpoint and refreshes it on a background ticker
    (gofr `oauth.go:53-71`). Keys are kept as `cryptography` public keys."""

    def __init__(self, url: str, refresh_interval: float = 300.0, timeout: float = 5.0):
        self.url = url
        self._interval = refresh_interval
        self._timeout = timeout
        self._keys: dict[str, Any] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self.refresh()
        self._thread = threading.Thread(target=self._run, name="gofr-jwks-refresh", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            self.refresh()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self._timeout + 1.0)

    def refresh(self) -> None:
        try:
            with urllib.request.urlopen(self.url, timeout=self._timeout) as resp:
                data = json.loads(resp.read())
        except Exception:  # noqa: BLE001 - keep stale keys on fetch failure
            return
        keys: dict[str, Any] = {}
        for jwk in data.get("keys", []):
            key = self._jwk_to_public_key(jwk)
            if key is not None:
                keys[jwk.get("kid", "")] = key
        if keys:
            with self._lock:
                self._keys = keys

    @staticmethod
    def _jwk_to_public_key(jwk: dict[str, Any]):
        """RSA public key from JWK n/e (gofr `oauth.go:187-207`)."""
        if jwk.get("kty") != "RSA":
            return None
        try:
            from cryptography.hazmat.primitives.asymmetric.rsa import RSAPublicNumbers

            n = int.from_bytes(_b64url_decode(jwk["n"]), "big")
            e = int.from_bytes(_b64url_decode(jwk["e"]), "big")
            return RSAPublicNumbers(e, n).public_key()
        except Exception:  # noqa: BLE001
            return None

    def get(self, kid: str):
        with self._lock:
            if kid in self._keys:
                return self._keys[kid]
            if len(self._keys) == 1 and not kid:
                return next(iter(self._keys.values()))
        return None


def verify_jwt(token: str, jwks: JWKSCache | None = None, hs_secret: bytes | None = None,
               audience: str | None = None, issuer: str | None = None) -> dict[str, Any]:
    """Verify a compact JWT; returns claims or raises ValueError."""
    parts = token.split(".")
    if len(parts) != 3:
        raise ValueError("malformed token")
    header_b64, payload_b64, sig_b64 = parts
    try:
        header = json.loads(_b64url_decode(header_b64))
        claims = json.loads(_b64url_decode(payload_b64))
        signature = _b64url_decode(sig_b64)
    except Exception as e:  # noqa: BLE001
        raise ValueError("malformed token") from e
    signing_input = f"{header_b64}.{payload_b64}".encode()
    alg = header.get("alg")

    if alg == "RS256":
        if jwks is None:
            raise ValueError("RS256 token but no JWKS configured")
        key = jwks.get(header.get("kid", ""))
        if key is None:
            raise ValueError(f"unknown key id {header.get('kid')!r}")
        from cryptography.exceptions import InvalidSignature
        from cryptography.hazmat.primitives import hashes
        from cryptography.hazmat.primitives.asymmetric import padding

        try:
            key.verify(signature, signing_input, padding.PKCS1v15(), hashes.SHA256())
        except InvalidSignature as e:
            raise ValueError("invalid signature") from e
    elif alg == "HS256":
        if hs_secret is None:
            raise ValueError("HS256 token but no shared secret configured")
        expected = hmac_mod.new(hs_secret, signing_input, hashlib.sha256).digest()
        if not hmac_mod.compare_digest(expected, signature):
            raise ValueError("invalid signature")
    else:
        raise ValueError(f"unsupported alg {alg!r}")

    now = time.time()
    if "exp" in claims and now > float(claims["exp"]) + 30:
        raise ValueError("token expired")
    if "nbf" in claims and now < float(claims["nbf"]) - 30:
        raise ValueError("token not yet valid")
    if audience is not None:
        aud = claims.get("aud")
        auds = aud if isinstance(aud, list) else [aud]
        if audience not in auds:
            raise ValueError("audience mismatch")
    if issuer is not None and claims.get("iss") != issuer:
        raise ValueError("issuer mismatch")
    return claims


def oauth_middleware(jwks: JWKSCache | None = None, hs_secret: bytes | None = None,
                     audience: str | None = None, issuer: str | None = None):
    async def mw(request: ServerRequest, handler):
        if request.path.startswith(WELL_KNOWN_PREFIX):
            return await handler(request)
        header = request.headers.get("authorization", "")
        if not header.startswith("Bearer "):
            return _unauthorized("missing bearer token")
        try:
            claims = verify_jwt(header[7:], jwks=jwks, hs_secret=hs_secret,
                                audience=audience, issuer=issuer)
        except ValueError as e:
            return _unauthorized(str(e))
        request.state[AUTH_KEY] = {
            "auth_user": str(claims.get("sub", "")),
            "auth_method": "oauth",
            "jwt_claims": claims,
        }
        return await handler(request)

    return mw
