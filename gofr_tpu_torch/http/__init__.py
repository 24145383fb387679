"""The port's HTTP layer (counterpart of gofr_tpu.http): typed errors, the
request wrapper, the JSON-envelope responder, SSE, the middleware chain,
and an HTTP/1.1 server on the standard library (``server.py``) in place of
aiohttp."""
