# Copied from simplex_tpu/web/microweb.py; keep in step (tests/test_torch_core.py).
"""Minimal WSGI micro-framework (stdlib + jinja2 only).

The reference uses Flask (``app/controllers/routers.py``);
Flask is not available in this environment, so the web layer runs on a small
from-scratch framework providing exactly what the app needs:

* route registration with per-method dispatch,
* form parsing (urlencoded + multipart file upload),
* HMAC-signed cookie sessions (replacing Flask's ``session``; the secret is
  configurable, unlike the reference's hardcoded key, ``routers.py:23``),
* flash messages, redirects, file downloads,
* jinja2 template rendering.
"""
from __future__ import annotations

import hashlib
import hmac
import http.cookies
import io
import json
import mimetypes
import os
import re
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

import jinja2

_STATUS = {
    200: "200 OK", 302: "302 Found", 400: "400 Bad Request",
    404: "404 Not Found", 405: "405 Method Not Allowed",
    500: "500 Internal Server Error",
}


class UploadedFile:
    def __init__(self, filename: str, content: bytes):
        self.filename = filename
        self.content = content

    def read(self) -> bytes:
        return self.content


def _parse_multipart(body: bytes, content_type: str):
    """Tiny multipart/form-data parser (the stdlib ``cgi`` module is
    deprecated/removed; this covers the forms the app serves)."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    fields: Dict[str, List[str]] = {}
    files: Dict[str, UploadedFile] = {}
    if not m:
        return fields, files
    boundary = b"--" + m.group(1).encode()
    for part in body.split(boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        if b"\r\n\r\n" not in part:
            continue
        header_blob, content = part.split(b"\r\n\r\n", 1)
        headers = {}
        for line in header_blob.split(b"\r\n"):
            if b":" in line:
                k, v = line.split(b":", 1)
                headers[k.decode().lower().strip()] = v.decode().strip()
        disp = headers.get("content-disposition", "")
        name_m = re.search(r'name="([^"]*)"', disp)
        if not name_m:
            continue
        name = name_m.group(1)
        file_m = re.search(r'filename="([^"]*)"', disp)
        if file_m:
            files[name] = UploadedFile(file_m.group(1), content)
        else:
            fields.setdefault(name, []).append(content.decode("utf-8"))
    return fields, files


class Request:
    def __init__(self, environ: Dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO", "/")
        self.query = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""))
        self._form: Optional[Dict[str, List[str]]] = None
        self._files: Dict[str, UploadedFile] = {}
        self._body: Optional[bytes] = None

    @property
    def body(self) -> bytes:
        if self._body is None:
            try:
                length = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                length = 0
            self._body = (self.environ["wsgi.input"].read(length)
                          if length else b"")
        return self._body

    def _parse(self):
        if self._form is not None:
            return
        ctype = self.environ.get("CONTENT_TYPE", "")
        if ctype.startswith("multipart/form-data"):
            self._form, self._files = _parse_multipart(self.body, ctype)
        elif ctype.startswith("application/x-www-form-urlencoded"):
            self._form = urllib.parse.parse_qs(
                self.body.decode("utf-8"), keep_blank_values=True)
        else:
            self._form = {}

    @property
    def form(self) -> "FormProxy":
        self._parse()
        return FormProxy(self._form)

    @property
    def files(self) -> Dict[str, UploadedFile]:
        self._parse()
        return self._files

    @property
    def cookies(self) -> Dict[str, str]:
        jar = http.cookies.SimpleCookie(self.environ.get("HTTP_COOKIE", ""))
        return {k: v.value for k, v in jar.items()}


class FormProxy:
    """Flask-ish form access: ``form.get(k)`` scalar, ``getlist(k)`` list."""

    def __init__(self, data: Dict[str, List[str]]):
        self._d = data or {}

    def get(self, key: str, default: str = "") -> str:
        vals = self._d.get(key)
        return vals[0] if vals else default

    def getlist(self, key: str) -> List[str]:
        return list(self._d.get(key, []))

    def __contains__(self, key):
        return key in self._d


class Response:
    def __init__(self, body: Any = b"", status: int = 200,
                 content_type: str = "text/html; charset=utf-8",
                 headers: Optional[List[Tuple[str, str]]] = None):
        if isinstance(body, str):
            body = body.encode("utf-8")
        self.body = body
        self.status = status
        self.headers = list(headers or [])
        self.headers.append(("Content-Type", content_type))

    def set_cookie(self, name: str, value: str, path: str = "/",
                   http_only: bool = True):
        cookie = f"{name}={value}; Path={path}"
        if http_only:
            cookie += "; HttpOnly"
        self.headers.append(("Set-Cookie", cookie))


class SignedSession(dict):
    """HMAC-SHA256-signed JSON cookie session."""

    COOKIE = "stx_session"

    @classmethod
    def load(cls, request: Request, secret: str) -> "SignedSession":
        raw = request.cookies.get(cls.COOKIE, "")
        sess = cls()
        if "." in raw:
            payload, sig = raw.rsplit(".", 1)
            expect = hmac.new(secret.encode(), payload.encode(),
                              hashlib.sha256).hexdigest()
            if hmac.compare_digest(sig, expect):
                try:
                    data = json.loads(
                        urllib.parse.unquote_plus(payload))
                    sess.update(data)
                except (ValueError, TypeError):
                    pass
        return sess

    def dump(self, secret: str) -> str:
        payload = urllib.parse.quote_plus(
            json.dumps(self, separators=(",", ":")))
        sig = hmac.new(secret.encode(), payload.encode(),
                       hashlib.sha256).hexdigest()
        return f"{payload}.{sig}"


class WebApp:
    """Route table + WSGI callable with sessions, flash, and templates."""

    def __init__(self, template_dir: str, static_dir: str, secret_key: str):
        self.routes: Dict[str, Dict[str, Callable]] = {}
        self.secret_key = secret_key
        self.static_dir = static_dir
        self.jinja = jinja2.Environment(
            loader=jinja2.FileSystemLoader(template_dir),
            autoescape=jinja2.select_autoescape(["html"]),
        )

    def route(self, path: str, methods=("GET",)):
        def wrap(fn):
            self.routes.setdefault(path, {})
            for m in methods:
                self.routes[path][m.upper()] = fn
            return fn
        return wrap

    # ------------------------------------------------------------------ #
    # helpers available to handlers via the context object                #
    # ------------------------------------------------------------------ #
    def render(self, ctx: "Ctx", template: str, **kwargs) -> Response:
        tpl = self.jinja.get_template(template)
        flashes = ctx.session.pop("_flashes", [])
        html = tpl.render(get_flashed_messages=lambda: flashes, **kwargs)
        return Response(html)

    def redirect(self, location: str) -> Response:
        return Response(b"", status=302, headers=[("Location", location)])

    def send_file(self, path: str, download_name: Optional[str] = None,
                  as_attachment: bool = True) -> Response:
        with open(path, "rb") as f:
            data = f.read()
        ctype = (mimetypes.guess_type(download_name or path)[0]
                 or "application/octet-stream")
        headers = []
        if as_attachment:
            headers.append((
                "Content-Disposition",
                f'attachment; filename="{download_name or os.path.basename(path)}"',
            ))
        return Response(data, content_type=ctype, headers=headers)

    def send_bytes(self, data: bytes, download_name: str,
                   content_type: Optional[str] = None) -> Response:
        ctype = (content_type or mimetypes.guess_type(download_name)[0]
                 or "application/octet-stream")
        return Response(data, content_type=ctype, headers=[(
            "Content-Disposition",
            f'attachment; filename="{download_name}"')])

    # ------------------------------------------------------------------ #
    def _serve_static(self, path: str) -> Response:
        rel = path[len("/static/"):]
        full = os.path.normpath(os.path.join(self.static_dir, rel))
        if not full.startswith(os.path.abspath(self.static_dir)) \
                or not os.path.isfile(full):
            return Response(b"Not Found", status=404,
                            content_type="text/plain")
        ctype = mimetypes.guess_type(full)[0] or "application/octet-stream"
        with open(full, "rb") as f:
            return Response(f.read(), content_type=ctype)

    def __call__(self, environ, start_response):
        request = Request(environ)
        if request.path.startswith("/static/"):
            resp = self._serve_static(request.path)
            start_response(_STATUS[resp.status], resp.headers)
            return [resp.body]

        session = SignedSession.load(request, self.secret_key)
        ctx = Ctx(self, request, session)
        handlers = self.routes.get(request.path)
        try:
            if handlers is None:
                resp = Response(b"Not Found", status=404,
                                content_type="text/plain")
            elif request.method not in handlers:
                resp = Response(b"Method Not Allowed", status=405,
                                content_type="text/plain")
            else:
                out = handlers[request.method](ctx)
                resp = out if isinstance(out, Response) else Response(out)
        except Exception:
            import traceback
            traceback.print_exc()
            resp = Response(b"Internal Server Error", status=500,
                            content_type="text/plain")
        resp.set_cookie(SignedSession.COOKIE, session.dump(self.secret_key))
        start_response(_STATUS.get(resp.status, "500 Internal Server Error"),
                       resp.headers)
        return [resp.body]


class Ctx:
    """Per-request context handed to handlers."""

    def __init__(self, app: WebApp, request: Request,
                 session: SignedSession):
        self.app = app
        self.request = request
        self.session = session

    def flash(self, message: str, category: str = "info"):
        self.session.setdefault("_flashes", []).append([category, message])

    # sugar
    def render(self, template: str, **kw) -> Response:
        return self.app.render(self, template, **kw)

    def redirect(self, location: str) -> Response:
        return self.app.redirect(location)


class TestClient:
    """In-process WSGI test client (the pytest equivalent of Flask's)."""

    def __init__(self, app: WebApp):
        self.app = app
        self._cookies: Dict[str, str] = {}

    def _call(self, method: str, path: str, data=None, files=None,
              follow_redirects: bool = False):
        body = b""
        ctype = ""
        if files:
            boundary = "stxboundary123"
            parts = []
            for k, v in (data or {}).items():
                vals = v if isinstance(v, list) else [v]
                for val in vals:
                    parts.append(
                        f'--{boundary}\r\nContent-Disposition: form-data; '
                        f'name="{k}"\r\n\r\n{val}\r\n'.encode())
            for k, (fname, content) in files.items():
                if isinstance(content, str):
                    content = content.encode()
                parts.append(
                    f'--{boundary}\r\nContent-Disposition: form-data; '
                    f'name="{k}"; filename="{fname}"\r\n'
                    f'Content-Type: application/octet-stream\r\n\r\n'.encode()
                    + content + b"\r\n")
            body = b"".join(parts) + f"--{boundary}--\r\n".encode()
            ctype = f"multipart/form-data; boundary={boundary}"
        elif data is not None:
            pairs = []
            for k, v in data.items():
                vals = v if isinstance(v, list) else [v]
                for val in vals:
                    pairs.append((k, str(val)))
            body = urllib.parse.urlencode(pairs).encode()
            ctype = "application/x-www-form-urlencoded"

        path_only, _, qs = path.partition("?")
        environ = {
            "REQUEST_METHOD": method,
            "PATH_INFO": path_only,
            "QUERY_STRING": qs,
            "CONTENT_TYPE": ctype,
            "CONTENT_LENGTH": str(len(body)),
            "wsgi.input": io.BytesIO(body),
            "HTTP_COOKIE": "; ".join(f"{k}={v}"
                                     for k, v in self._cookies.items()),
        }
        status_headers = {}

        def start_response(status, headers):
            status_headers["status"] = status
            status_headers["headers"] = headers

        chunks = self.app(environ, start_response)
        for name, value in status_headers["headers"]:
            if name == "Set-Cookie":
                k, _, rest = value.partition("=")
                self._cookies[k] = rest.split(";")[0]
        resp = ClientResponse(
            status=int(status_headers["status"].split()[0]),
            headers=status_headers["headers"],
            data=b"".join(chunks),
        )
        if follow_redirects and resp.status in (301, 302):
            loc = dict(resp.headers).get("Location", "/")
            return self._call("GET", loc, follow_redirects=True)
        return resp

    def get(self, path, **kw):
        return self._call("GET", path, **kw)

    def post(self, path, **kw):
        return self._call("POST", path, **kw)


class ClientResponse:
    def __init__(self, status: int, headers, data: bytes):
        self.status = status
        self.status_code = status
        self.headers = headers
        self.data = data

    @property
    def text(self) -> str:
        return self.data.decode("utf-8", errors="replace")


def run_dev_server(app: WebApp, host: str = "0.0.0.0", port: int = 5000):
    from wsgiref.simple_server import make_server
    with make_server(host, port, app) as server:
        print(f"simplex_tpu web on http://{host}:{port}")
        server.serve_forever()
