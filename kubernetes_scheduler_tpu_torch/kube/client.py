"""Minimal Kubernetes REST client (stdlib only).

The reference reaches the API server through client-go with QPS and Burst
raised to 1000 (pkg/yoda/scheduler.go:58-60, ctrl.GetConfigOrDie). This
client reproduces that contract — bearer-token/CA auth, in-cluster and
kubeconfig bootstraps, a 1000/1000 token-bucket limiter — on urllib, so
the scheduler binary needs no vendored client library.

Streaming watches use the API server's `?watch=true` endpoint, which
returns newline-delimited JSON events over a chunked response
(WatchEvent: {"type": "ADDED"|"MODIFIED"|"DELETED", "object": {...}}).

The port's copy of kubernetes_scheduler_tpu/kube/client.py.
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from dataclasses import dataclass

log = logging.getLogger("yoda_tpu.kube")

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiError(RuntimeError):
    def __init__(self, status: int, method: str, path: str, body: str = ""):
        self.status = status
        self.path = path
        super().__init__(f"{method} {path} -> HTTP {status}: {body[:300]}")


@dataclass
class KubeConfig:
    """Connection parameters for one API server."""

    base_url: str                      # e.g. https://10.0.0.1:443
    token: str | None = None           # static bearer token
    # path to a (projected, kubelet-rotated) token file: re-read per
    # request like client-go, so the scheduler survives the ~1h bound
    # service-account token rotation instead of 401-ing forever
    token_path: str | None = None
    ca_path: str | None = None         # CA bundle file for TLS verification
    ca_data: str | None = None         # inline PEM CA bundle
    insecure: bool = False             # skip TLS verification
    namespace: str = "default"

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        """Pod-mounted service account (what GetConfigOrDie resolves to
        when running inside the cluster)."""
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        if not host:
            raise RuntimeError(
                "not in cluster: KUBERNETES_SERVICE_HOST unset and no "
                "kubeconfig given"
            )
        ns_path = f"{SERVICE_ACCOUNT_DIR}/namespace"
        namespace = "default"
        if os.path.exists(ns_path):
            with open(ns_path) as f:
                namespace = f.read().strip() or "default"
        return cls(
            base_url=f"https://{host}:{port}",
            token_path=f"{SERVICE_ACCOUNT_DIR}/token",
            ca_path=f"{SERVICE_ACCOUNT_DIR}/ca.crt",
            namespace=namespace,
        )

    @classmethod
    def from_kubeconfig(cls, path: str | None = None) -> "KubeConfig":
        """Parse the (current-context of a) kubeconfig file. Supports the
        common token / client-less auth fields; client-cert auth is out of
        scope for the scheduler's service-account deployment."""
        import yaml

        path = path or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config")
        )
        with open(path) as f:
            doc = yaml.safe_load(f)
        ctx_name = doc.get("current-context")
        ctx = next(
            c["context"] for c in doc.get("contexts", [])
            if c["name"] == ctx_name
        )
        cluster = next(
            c["cluster"] for c in doc.get("clusters", [])
            if c["name"] == ctx["cluster"]
        )
        user = next(
            (u["user"] for u in doc.get("users", []) if u["name"] == ctx.get("user")),
            {},
        )
        ca_data = cluster.get("certificate-authority-data")
        if ca_data:
            # the form generated kubeconfigs (kind/kubeadm/cloud) use:
            # base64-embedded PEM rather than a file path
            import base64

            ca_data = base64.b64decode(ca_data).decode()
        return cls(
            base_url=cluster["server"].rstrip("/"),
            token=user.get("token"),
            token_path=user.get("tokenFile"),
            ca_path=cluster.get("certificate-authority"),
            ca_data=ca_data,
            insecure=bool(cluster.get("insecure-skip-tls-verify", False)),
            namespace=ctx.get("namespace", "default"),
        )


class _TokenBucket:
    """client-go flowcontrol analog: qps refill, burst capacity."""

    def __init__(self, qps: float, burst: int):
        self.qps = float(qps)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self) -> None:
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps
                )
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.qps
            time.sleep(wait)


class KubeClient:
    """Rate-limited JSON REST client for one API server.

    qps/burst default to the reference's 1000/1000
    (pkg/yoda/scheduler.go:59-60).
    """

    def __init__(
        self,
        config: KubeConfig,
        *,
        qps: float = 1000.0,
        burst: int = 1000,
        timeout: float = 30.0,
    ):
        self.config = config
        self.timeout = timeout
        self._bucket = _TokenBucket(qps, burst)
        self._token_cache: tuple[float, str] | None = None
        self._ssl_ctx: ssl.SSLContext | None = None
        if config.base_url.startswith("https"):
            if config.insecure:
                ctx = ssl.create_default_context()
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
            elif config.ca_path or config.ca_data:
                ctx = ssl.create_default_context(
                    cafile=config.ca_path, cadata=config.ca_data
                )
            else:
                ctx = ssl.create_default_context()
            self._ssl_ctx = ctx

    def _token(self) -> str | None:
        """Current bearer token. File-backed tokens are re-read (with a
        60s cache) so kubelet rotation of projected tokens takes effect
        without a restart — client-go behavior."""
        if self.config.token_path:
            now = time.monotonic()
            if self._token_cache is None or now - self._token_cache[0] > 60.0:
                with open(self.config.token_path) as f:
                    self._token_cache = (now, f.read().strip())
            return self._token_cache[1]
        return self.config.token

    # -- plumbing --------------------------------------------------------

    def _url(self, path: str, params: dict | None = None) -> str:
        url = self.config.base_url + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        return url

    def _request(
        self,
        method: str,
        path: str,
        params: dict | None = None,
        body: dict | None = None,
        *,
        timeout: float | None = None,
        stream: bool = False,
        content_type: str = "application/json",
    ):
        self._bucket.take()
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self._url(path, params), data=data, method=method
        )
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        token = self._token()
        if token:
            req.add_header("Authorization", f"Bearer {token}")
        try:
            resp = urllib.request.urlopen(
                req,
                timeout=self.timeout if timeout is None else timeout,
                context=self._ssl_ctx,
            )
        except urllib.error.HTTPError as e:
            detail = e.read().decode("utf-8", "replace")
            raise KubeApiError(e.code, method, path, detail) from None
        if stream:
            return resp
        with resp:
            payload = resp.read()
        return json.loads(payload) if payload else None

    # -- verbs -----------------------------------------------------------

    def get(self, path: str, params: dict | None = None):
        return self._request("GET", path, params)

    def post(self, path: str, body: dict):
        return self._request("POST", path, body=body)

    def put(self, path: str, body: dict):
        return self._request("PUT", path, body=body)

    def patch(self, path: str, body: dict):
        """Strategic-merge PATCH (the content type kubectl uses for
        annotation updates like VolumeBinding's selected-node)."""
        return self._request(
            "PATCH", path, body=body,
            content_type="application/strategic-merge-patch+json",
        )

    def delete(self, path: str, body: dict | None = None):
        return self._request("DELETE", path, body=body)

    def list_all(self, path: str, params: dict | None = None) -> list[dict]:
        """GET a List object, following `continue` pagination."""
        return self.list_with_rv(path, params)[0]

    def list_with_rv(
        self, path: str, params: dict | None = None
    ) -> tuple[list[dict], str | None]:
        """list_all plus the List's resourceVersion — the token a
        subsequent watch resumes from (the informer list-then-watch
        handshake)."""
        params = dict(params or {})
        items: list[dict] = []
        while True:
            doc = self.get(path, params) or {}
            items.extend(doc.get("items", []))
            meta = doc.get("metadata") or {}
            cont = meta.get("continue")
            if not cont:
                return items, meta.get("resourceVersion")
            params["continue"] = cont

    def watch(
        self,
        path: str,
        params: dict | None = None,
        *,
        timeout_seconds: float = 60.0,
    ):
        """Yield watch events (dicts with 'type' and 'object') until the
        server closes the stream or timeout_seconds elapses server-side."""
        params = dict(params or {})
        params["watch"] = "true"
        params.setdefault("timeoutSeconds", str(int(timeout_seconds)))
        resp = self._request(
            "GET", path, params, timeout=timeout_seconds + 10.0, stream=True
        )
        with resp:
            for line in resp:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    log.warning("undecodable watch line: %.120r", line)
