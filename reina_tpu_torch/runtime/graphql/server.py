"""Stdlib HTTP server for the GraphQL API (port of
reina_tpu/runtime/graphql/server.py; reference: graphql_backend.py —
Flask + CORS + signed sessions).

Thread-per-request ``ThreadingHTTPServer``; per-client variable
sessions ride an HMAC-signed cookie holding the override dict (the
reference stores the same overrides in a signed Flask session cookie).
The server runs simulations and explorer draws on one device, ``cuda``
unless ``serve(device="cpu")`` asks for the CPU.

  POST /graphql         {"query": ..., "variables": ..., "operationName": ...}
  GET  /healthz
  GET  /                the web UI
  GET  /export.xlsx?run=<run id>
"""
from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .engine import execute
from .schema import SCHEMA
from ...config.variables import DEFAULT_VARIABLE_HASH, VariableStore
from ...utils.locale import DEFAULT_LOCALE, TRANSLATIONS, set_active_locale

# via config.settings so the .env loader has run before the key is read
from ...config import settings as _settings

SECRET = _settings.SECRET_KEY.encode()
COOKIE_NAME = "reina_session"

# The IDE shell loads the graphiql bundle from a CDN in the client's
# browser, exactly like Flask-GraphQL's graphiql=True template does.
def _warmup_logged(device) -> None:
    import time
    t0 = time.perf_counter()
    try:
        warmup_serving_program(device)
        print("serving-program warm-up done in "
              f"{time.perf_counter() - t0:.1f}s")
    except Exception as e:  # noqa: BLE001 — warm-up is best-effort
        print(f"serving-program warm-up failed (non-fatal): {e}")


GRAPHIQL_HTML = """<!DOCTYPE html>
<html>
<head>
  <title>GraphiQL — REINA</title>
  <style>body { margin: 0; } #graphiql { height: 100vh; }</style>
  <link rel="stylesheet" href="https://unpkg.com/graphiql/graphiql.min.css"/>
</head>
<body>
  <div id="graphiql">Loading GraphiQL…</div>
  <script crossorigin src="https://unpkg.com/react@18/umd/react.production.min.js"></script>
  <script crossorigin src="https://unpkg.com/react-dom@18/umd/react-dom.production.min.js"></script>
  <script crossorigin src="https://unpkg.com/graphiql/graphiql.min.js"></script>
  <script>
    const fetcher = (params) => fetch('/graphql', {
      method: 'POST',
      credentials: 'same-origin',
      headers: {'Content-Type': 'application/json'},
      body: JSON.stringify(params),
    }).then(r => r.json());
    ReactDOM.createRoot(document.getElementById('graphiql')).render(
      React.createElement(GraphiQL, {fetcher: fetcher}));
  </script>
</body>
</html>
"""


def _sign(payload: bytes) -> str:
    mac = hmac.new(SECRET, payload, hashlib.sha256).digest()[:16]
    return (base64.urlsafe_b64encode(payload).decode() + "."
            + base64.urlsafe_b64encode(mac).decode())


def _verify(token: str) -> Optional[bytes]:
    try:
        body, mac = token.split(".")
        payload = base64.urlsafe_b64decode(body)
        want = hmac.new(SECRET, payload, hashlib.sha256).digest()[:16]
        if hmac.compare_digest(want, base64.urlsafe_b64decode(mac)):
            return payload
    except Exception:
        pass
    return None


def load_session(cookie_header: Optional[str]) -> VariableStore:
    if cookie_header:
        for part in cookie_header.split(";"):
            name, _, value = part.strip().partition("=")
            if name == COOKIE_NAME:
                payload = _verify(value)
                if payload is not None:
                    try:
                        data = json.loads(payload)
                        # invalidate sessions built against older defaults
                        if data.get("_hash") == DEFAULT_VARIABLE_HASH:
                            data.pop("_hash", None)
                            return VariableStore(data)
                    except Exception:
                        pass
    return VariableStore()


def dump_session(store: VariableStore) -> str:
    data = store.overrides()
    data["_hash"] = DEFAULT_VARIABLE_HASH
    return _sign(json.dumps(data, sort_keys=True).encode())


class GraphQLHandler(BaseHTTPRequestHandler):
    server_version = "reina-tpu-torch"

    def _cors(self) -> None:
        # Reflecting every Origin WITH credentials would grant any
        # website credentialed API access. Only allowlisted origins
        # (settings.CORS_ORIGINS, e.g. the reina-ui deployment) get
        # credentialed reflection; everyone else gets the reference's
        # flask-cors default — '*' without credentials
        # (graphql_backend.py:31 CORS(app)).
        origin = self.headers.get("Origin")
        if origin and origin in _settings.CORS_ORIGINS:
            self.send_header("Access-Control-Allow-Origin", origin)
            self.send_header("Access-Control-Allow-Credentials", "true")
            self.send_header("Vary", "Origin")
        else:
            self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Headers",
                         "Content-Type, Authorization")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")

    def do_OPTIONS(self) -> None:  # noqa: N802
        self.send_response(204)
        self._cors()
        self.end_headers()

    def do_GET(self) -> None:  # noqa: N802
        if self.path.startswith("/healthz"):
            body = b'{"status": "ok"}'
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path in ("/", "/index.html"):
            from ...webui import app_html
            body = app_html()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.split("?")[0] == "/export.xlsx":
            # Excel download of a finished run's daily result table —
            # the reference's dash_table export (components/results.py:
            # 294-331) served the displayed DataFrame as .xlsx
            from urllib.parse import parse_qs, urlparse

            from .. import cache
            from ..xlsx import workbook_bytes

            run_id = (parse_qs(urlparse(self.path).query)
                      .get("run") or [""])[0]
            results = cache.get("%s-results" % run_id) if run_id else None
            if results is None:
                self.send_response(404)
                self._cors()
                self.end_headers()
                return
            cols = results["total"]
            names = [c for c in cols if c != "date"]
            header = ["date"] + names
            rows = ([str(d)] + [cols[c][i] for c in names]
                    for i, d in enumerate(cols["date"]))
            body = workbook_bytes(header, rows)
            self.send_response(200)
            self._cors()
            self.send_header(
                "Content-Type", "application/vnd.openxmlformats-"
                "officedocument.spreadsheetml.sheet")
            self.send_header("Content-Disposition",
                             'attachment; filename="reina_results.xlsx"')
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        if self.path.split("?")[0] == "/graphql":
            # graphiql IDE, like the reference's Flask-GraphQL view
            # (graphql_backend.py:40-45, graphiql=True)
            body = GRAPHIQL_HTML.encode()
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            return
        self.send_response(404)
        self.end_headers()

    def do_POST(self) -> None:  # noqa: N802
        if not self.path.startswith("/graphql"):
            self.send_response(404)
            self.end_headers()
            return
        length = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            self.send_response(400)
            self.end_headers()
            return

        store = load_session(self.headers.get("Cookie"))
        # per-request locale: ?lang cookie wins, else Accept-Language
        # (reference common/locale.py:15-23)
        set_active_locale(self._request_locale())
        result = execute(SCHEMA, req.get("query", ""),
                         variables=req.get("variables"),
                         operation_name=req.get("operationName"),
                         context={"store": store,
                                  "device": self.server.device})
        body = json.dumps(result).encode()
        self.send_response(200)
        self._cors()
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.send_header(
            "Set-Cookie",
            f"{COOKIE_NAME}={dump_session(store)}; Path=/; HttpOnly; SameSite=Lax")
        self.end_headers()
        self.wfile.write(body)

    def _request_locale(self) -> str:
        cookies = self.headers.get("Cookie") or ""
        for part in cookies.split(";"):
            name, _, value = part.strip().partition("=")
            if name == "lang" and value in TRANSLATIONS:
                return value
        accept = self.headers.get("Accept-Language") or ""
        for item in accept.split(","):
            code = item.split(";")[0].strip().split("-")[0].lower()
            if code in TRANSLATIONS:
                return code
        return DEFAULT_LOCALE

    def log_message(self, fmt, *args):  # quiet access log
        pass


def warmup_serving_program(device="cuda") -> None:
    """Build the default session's run before the first client run:
    build the kernels (on CUDA), put the run into the build cache
    (``simulation.BUILD_CACHE``) under the variables a default-session
    ``simulate_individuals`` resolves, and step it through one 7-day
    chunk (the streaming interval) and one 1-day chunk (the tail of any
    ``simulation_days`` whose steps do not divide by 7), which also
    compiles the Triton bodies; on a card, then build the day graph of
    every host key of its days (core/graphs.py) without stepping them.
    The first client run of the default variables is then a build-cache
    hit whose graph set holds every day graph it needs; so is a build of
    the same shapes (another seed, preset scenario or parameters of the
    area, up to as many days), whose run takes the same set."""
    import torch

    from ...core.engine import build_graphs, run_days
    from ...simulation import BUILD_CACHE, resolve_device, simulate_individuals
    from ...utils.memoize import resolved_variables

    dev = resolve_device(device)
    if dev.type == "cuda":
        from ...kernels import build
        build.lib()
    variables = resolved_variables(simulate_individuals, {})
    run = BUILD_CACHE.get(variables, dev)
    out, _, _, _ = run_days(run, n_days=1 + 7 + 1, chunk_days=7)
    if dev.type == "cuda":
        build_graphs(run)
        torch.cuda.synchronize(dev)
    if out.by_group.shape[0] != 9:
        raise RuntimeError(f"warm-up ran {out.by_group.shape[0]} rows, want 9")


def serve(host: str = "0.0.0.0", port: int = 5000,
          background: bool = False,
          warmup: Optional[bool] = None,
          device="cuda") -> Optional[ThreadingHTTPServer]:
    """Serve the API and the web UI; runs go on ``device``. Without a
    card, ``device="cuda"`` raises here, before the port is bound."""
    from ...simulation import resolve_device
    dev = str(resolve_device(device))
    # default: warm up for foreground (production) servers unless
    # REINA_WARMUP=0; background servers (tests, embedding) skip it
    if warmup is None:
        warmup = (not background
                  and os.environ.get("REINA_WARMUP", "1") == "1")
    if warmup:
        t = threading.Thread(target=_warmup_logged, args=(dev,), daemon=True)
        t.start()
    httpd = ThreadingHTTPServer((host, port), GraphQLHandler)
    httpd.device = dev
    if background:
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        return httpd
    print(f"GraphQL API listening on http://{host}:{port}/graphql "
          f"(runs on {dev})")
    httpd.serve_forever()
    return None


if __name__ == "__main__":
    serve(port=int(os.environ.get("PORT", 5000)))
