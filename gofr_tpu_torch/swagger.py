"""OpenAPI serving (gofr `pkg/gofr/swagger.go`), the port's own copy of
gofr_tpu/swagger.py, answering through ``http/server.py``.

Serves ``./static/openapi.json`` at ``/.well-known/openapi.json`` when present;
otherwise generates a minimal spec from the registered routes.
``/.well-known/swagger`` serves API docs. The reference EMBEDS the Swagger-UI
bundle (`swagger.go:13-14` ``//go:embed static/*``) so docs work air-gapped;
this build ships an in-tree, dependency-free docs UI with the same property —
spec rendering plus try-it-out via ``fetch`` — with zero external assets.
Set ``SWAGGER_UI=cdn`` to serve the full Swagger-UI from unpkg instead
(requires egress).
"""

from __future__ import annotations

import json
import os

from gofr_tpu_torch.http.server import ServerRequest, ServerResponse

_CDN_HTML = """<!DOCTYPE html>
<html>
<head>
  <title>{title} — API docs</title>
  <link rel="stylesheet" href="https://unpkg.com/swagger-ui-dist@5/swagger-ui.css">
</head>
<body>
  <div id="swagger-ui"></div>
  <script src="https://unpkg.com/swagger-ui-dist@5/swagger-ui-bundle.js"></script>
  <script>
    SwaggerUIBundle({{url: "/.well-known/openapi.json", dom_id: "#swagger-ui"}});
  </script>
</body>
</html>"""

# Self-contained docs page: no external JS/CSS, works in air-gapped
# deployments (the property go:embed gives the reference).
_OFFLINE_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8">
<title>{title} — API docs</title>
<style>
  :root {{ --fg:#1a1a2e; --muted:#667; --line:#e2e4ea; --bg:#fff; --chip:#f2f4f8; }}
  body {{ font: 15px/1.5 system-ui, sans-serif; color: var(--fg); background: var(--bg);
         margin: 0 auto; max-width: 960px; padding: 24px; }}
  h1 {{ font-size: 22px; }} h1 small {{ color: var(--muted); font-weight: 400; }}
  .op {{ border: 1px solid var(--line); border-radius: 8px; margin: 10px 0; }}
  .op > summary {{ cursor: pointer; padding: 10px 14px; display: flex; gap: 12px;
                   align-items: center; list-style: none; }}
  .op > summary::-webkit-details-marker {{ display: none; }}
  .method {{ font: 600 12px/1 monospace; padding: 4px 8px; border-radius: 4px;
             color: #fff; min-width: 52px; text-align: center; }}
  .get {{ background:#2f855a }} .post {{ background:#2b6cb0 }} .put {{ background:#b7791f }}
  .delete {{ background:#c53030 }} .patch {{ background:#6b46c1 }}
  .path {{ font-family: monospace; }}
  .summary {{ color: var(--muted); margin-left: auto; }}
  .body {{ border-top: 1px solid var(--line); padding: 12px 14px; }}
  textarea, input {{ width: 100%; box-sizing: border-box; font-family: monospace;
                     border: 1px solid var(--line); border-radius: 6px; padding: 8px; }}
  button {{ background: var(--fg); color: #fff; border: 0; border-radius: 6px;
            padding: 8px 16px; cursor: pointer; margin-top: 8px; }}
  pre {{ background: var(--chip); border-radius: 6px; padding: 10px; overflow: auto; }}
  .param {{ margin: 6px 0; }} .param label {{ font-family: monospace; font-size: 13px; }}
</style>
</head>
<body>
<h1>{title} <small>API documentation</small></h1>
<p><a href="/.well-known/openapi.json">openapi.json</a></p>
<div id="ops">loading spec…</div>
<script>
(async () => {{
  const spec = await (await fetch("/.well-known/openapi.json")).json();
  const root = document.getElementById("ops");
  root.textContent = "";
  for (const [path, methods] of Object.entries(spec.paths || {{}})) {{
    for (const [method, op] of Object.entries(methods)) {{
      const d = document.createElement("details"); d.className = "op";
      const params = (path.match(/\\{{([^}}]+)\\}}/g) || []).map(p => p.slice(1, -1));
      d.innerHTML = `
        <summary><span class="method ${{method}}">${{method.toUpperCase()}}</span>
          <span class="path">${{path}}</span>
          <span class="summary">${{(op.summary || "")}}</span></summary>
        <div class="body">
          ${{params.map(p => `<div class="param"><label>${{p}}</label>
            <input data-param="${{p}}" placeholder="path parameter ${{p}}"></div>`).join("")}}
          ${{method !== "get" ? '<textarea rows="4" placeholder="request body (JSON)"></textarea>' : ""}}
          <button>Send request</button>
          <pre hidden></pre>
        </div>`;
      const out = d.querySelector("pre");
      d.querySelector("button").onclick = async () => {{
        let url = path;
        d.querySelectorAll("input[data-param]").forEach(i =>
          url = url.replace(`{{${{i.dataset.param}}}}`, encodeURIComponent(i.value)));
        const ta = d.querySelector("textarea");
        const init = {{ method: method.toUpperCase(), headers: {{}} }};
        if (ta && ta.value) {{
          init.body = ta.value; init.headers["Content-Type"] = "application/json";
        }}
        out.hidden = false; out.textContent = "…";
        try {{
          const r = await fetch(url, init);
          const text = await r.text();
          let shown = text;
          try {{ shown = JSON.stringify(JSON.parse(text), null, 2); }} catch {{}}
          out.textContent = `HTTP ${{r.status}}\\n` + shown;
        }} catch (e) {{ out.textContent = "request failed: " + e; }}
      }};
      root.appendChild(d);
    }}
  }}
  if (!root.children.length) root.textContent = "no routes registered";
}})();
</script>
</body>
</html>"""


def generate_spec(app) -> dict:
    paths: dict[str, dict] = {}
    for method, path, handler in app._routes:
        openapi_path = path  # the router's {param} syntax == OpenAPI syntax
        entry = paths.setdefault(openapi_path, {})
        entry[method.lower()] = {
            "summary": (handler.__doc__ or "").strip().split("\n")[0] or handler.__name__,
            "responses": {"200": {"description": "JSON envelope {\"data\": ...}"}},
        }
    return {
        "openapi": "3.0.0",
        "info": {"title": app.container.app_name, "version": app.container.app_version},
        "paths": paths,
    }


def openapi_handler(app):
    async def handler(_request: ServerRequest) -> ServerResponse:
        path = os.path.join("static", "openapi.json")
        if os.path.isfile(path):
            with open(path, "rb") as f:
                return ServerResponse(200, f.read())
        return ServerResponse(200, json.dumps(generate_spec(app)).encode())

    return handler


def swagger_ui_handler(app):
    async def handler(_request: ServerRequest) -> ServerResponse:
        mode = app.container.config.get_or_default("SWAGGER_UI", "offline")
        template = _CDN_HTML if mode == "cdn" else _OFFLINE_HTML
        html = template.format(title=app.container.app_name)
        return ServerResponse(200, html.encode(), content_type="text/html; charset=utf-8")

    return handler
