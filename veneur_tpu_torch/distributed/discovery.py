"""Service discovery: Consul and Kubernetes backends.

Parity: reference Discoverer interface (discoverer.go:5-7), Consul
health-API implementation (consul.go:29-47), Kubernetes pod-list
implementation (kubernetes.go:32-80, label app=veneur-global). HTTP access
goes through an injectable opener so tests stub responses the way the
reference stubs its Consul HTTP client (consul_discovery_test.go).
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import time
import urllib.request
from typing import Callable, Optional, Protocol

log = logging.getLogger("veneur_tpu_torch.discovery")


class Discoverer(Protocol):
    def get_destinations_for_service(self, service: str) -> list[str]: ...


class StaticDiscoverer:
    """Settable in-memory discoverer: the churn soak's scriptable
    discovery backend and a unit-test double. Membership changes go
    through set_destinations; fail_next/empty_next script the two
    flap modes a real backend exhibits (request error vs an empty
    passing-set answer), so DestinationRefresher's keep-last-good and
    staleness accounting are drivable deterministically."""

    def __init__(self, destinations: Optional[list[str]] = None) -> None:
        self._lock = threading.Lock()
        self._dests = list(destinations or [])
        self._fail_next = 0
        self._empty_next = 0
        self.calls = 0

    def set_destinations(self, destinations: list[str]) -> None:
        with self._lock:
            self._dests = list(destinations)

    def fail_next(self, n: int = 1) -> None:
        with self._lock:
            self._fail_next += int(n)

    def empty_next(self, n: int = 1) -> None:
        with self._lock:
            self._empty_next += int(n)

    def get_destinations_for_service(self, service: str) -> list[str]:
        with self._lock:
            self.calls += 1
            if self._fail_next > 0:
                self._fail_next -= 1
                raise ConnectionError("injected discovery failure")
            if self._empty_next > 0:
                self._empty_next -= 1
                return []
            return list(self._dests)


class FileWatchDiscoverer:
    """Watchable membership source: an mtime-polled file of members —
    the elastic tier's discovery backend (ROADMAP item 4: the interface
    matters, not the backend; a Consul watch or a k8s informer would
    slot in behind the same Discoverer protocol).

    Accepted formats, sniffed per read:

    - a JSON object ``{"members": [...], "standby": [...]}`` — the
      native format. ``standby`` is the provisioned-but-unrouted pool
      the autoscale controller promotes from / demotes to;
    - a bare JSON array of ``"host:port"`` strings (all members);
    - newline-separated plain text (``#`` comments and blanks skipped).

    The file is re-parsed only when its (mtime_ns, size, inode)
    signature changes — a poll against an unchanged file costs one
    stat. A missing file or malformed content raises, which the
    DestinationRefresher's keep-last-good path absorbs and counts.

    `write_members` is the controller's write-back half of the loop:
    an atomic tmp+rename rewrite (object format), so every consumer
    polling the file — this process's refresher AND any other proxy
    watching the same file — observes the new desired set on its next
    poll, never a torn write.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        self._lock = threading.Lock()
        self._sig: Optional[tuple] = None
        self._members: list[str] = []
        self._standby: list[str] = []
        self.reads = 0    # actual re-parses, not polls
        self.writes = 0

    @staticmethod
    def _parse(text: str) -> tuple[list[str], list[str]]:
        stripped = text.lstrip()
        if stripped[:1] in ("{", "["):
            data = json.loads(text)  # malformed JSON raises ValueError
            if isinstance(data, dict):
                members = [str(m) for m in data.get("members", [])]
                standby = [str(m) for m in data.get("standby", [])]
                return members, standby
            return [str(m) for m in data], []
        members = []
        for line in text.splitlines():
            line = line.strip()
            if line and not line.startswith("#"):
                members.append(line)
        return members, []

    def _load_locked(self) -> None:
        st = os.stat(self.path)  # missing file raises OSError
        sig = (st.st_mtime_ns, st.st_size, st.st_ino)
        if sig == self._sig:
            return
        with open(self.path) as f:
            text = f.read()
        self._members, self._standby = self._parse(text)
        self._sig = sig
        self.reads += 1

    def get_destinations_for_service(self, service: str = "") -> list[str]:
        with self._lock:
            self._load_locked()
            return list(self._members)

    def desired(self) -> tuple[list[str], list[str]]:
        """The controller's view: (members, standby), freshly polled."""
        with self._lock:
            self._load_locked()
            return list(self._members), list(self._standby)

    def write_members(self, members: list[str],
                      standby: Optional[list[str]] = None) -> None:
        """Atomically rewrite the desired member set (and standby pool);
        the rename bumps the signature so every poller re-reads."""
        with self._lock:
            if standby is None:
                standby = self._standby
            payload = json.dumps(
                {"members": list(members), "standby": list(standby)},
                indent=0)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path)
            st = os.stat(self.path)
            self._sig = (st.st_mtime_ns, st.st_size, st.st_ino)
            self._members = list(members)
            self._standby = list(standby)
            self.writes += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "path": self.path,
                "members": list(self._members),
                "standby": list(self._standby),
                "reads": self.reads,
                "writes": self.writes,
            }


def _default_opener(url: str, headers: Optional[dict] = None,
                    ca_file: Optional[str] = None, timeout: float = 10.0
                    ) -> bytes:
    req = urllib.request.Request(url, headers=headers or {})
    ctx = None
    if url.startswith("https"):
        ctx = ssl.create_default_context(
            cafile=ca_file) if ca_file else ssl.create_default_context()
    with urllib.request.urlopen(req, timeout=timeout, context=ctx) as resp:
        return resp.read()


class ConsulDiscoverer:
    """Queries Consul's health API for passing instances of a service."""

    def __init__(self, consul_url: str = "http://127.0.0.1:8500",
                 opener: Callable = _default_opener) -> None:
        self.consul_url = consul_url.rstrip("/")
        self.opener = opener

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = f"{self.consul_url}/v1/health/service/{service}?passing"
        body = self.opener(url)
        entries = json.loads(body)
        out = []
        for entry in entries:
            svc = entry.get("Service", {})
            addr = svc.get("Address") or entry.get("Node", {}).get("Address")
            port = svc.get("Port")
            if addr and port:
                out.append(f"{addr}:{port}")
        return out


class KubernetesDiscoverer:
    """Lists ready pods with label app=<service> through the API server
    using the in-cluster service account."""

    TOKEN_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/token"
    CA_PATH = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

    # projected service-account tokens rotate (kubelet refreshes the
    # file); a cached copy is only trustworthy for so long
    TOKEN_TTL_S = 300.0

    def __init__(self, api_url: str = "https://kubernetes.default.svc",
                 namespace: str = "default",
                 opener: Callable = _default_opener,
                 token: Optional[str] = None,
                 token_path: Optional[str] = None,
                 token_ttl_s: Optional[float] = None,
                 time_fn: Callable[[], float] = time.monotonic) -> None:
        self.api_url = api_url.rstrip("/")
        self.namespace = namespace
        self.opener = opener
        self.token_path = token_path or self.TOKEN_PATH
        self.token_ttl_s = (self.TOKEN_TTL_S if token_ttl_s is None
                            else float(token_ttl_s))
        self._time = time_fn
        self._token = token
        # a ctor-injected token is the caller's to manage and never
        # refreshes; only file-read tokens age out / retry on 401
        self._token_from_file = token is None
        self._token_read_at: Optional[float] = None
        self.token_rereads = 0

    def _read_token(self, force: bool = False) -> str:
        if not self._token_from_file:
            return self._token
        now = self._time()
        stale = (self._token_read_at is not None
                 and now - self._token_read_at >= self.token_ttl_s)
        if self._token is None or force or stale:
            with open(self.token_path) as f:
                self._token = f.read().strip()
            if self._token_read_at is not None:
                self.token_rereads += 1
            self._token_read_at = now
        return self._token

    @staticmethod
    def _auth_failed(exc: Exception) -> bool:
        return getattr(exc, "code", None) in (401, 403)

    def get_destinations_for_service(self, service: str) -> list[str]:
        url = (f"{self.api_url}/api/v1/namespaces/{self.namespace}/pods"
               f"?labelSelector=app%3D{service}")
        try:
            body = self.opener(
                url,
                headers={"Authorization": f"Bearer {self._read_token()}"},
                ca_file=self.CA_PATH,
            )
        except Exception as e:
            # a rejected credential on a file-read token usually means
            # the kubelet rotated it under us: re-read and retry once
            # before declaring the refresh failed
            if not (self._token_from_file and self._auth_failed(e)):
                raise
            log.warning("kubernetes API rejected token (%s); re-reading"
                        " %s and retrying", e, self.token_path)
            body = self.opener(
                url,
                headers={"Authorization":
                         f"Bearer {self._read_token(force=True)}"},
                ca_file=self.CA_PATH,
            )
        data = json.loads(body)
        out = []
        for pod in data.get("items", []):
            status = pod.get("status", {})
            if status.get("phase") != "Running":
                continue
            ip = status.get("podIP")
            ports = (
                pod.get("spec", {}).get("containers", [{}])[0]
                .get("ports", [])
            )
            by_name = {p.get("name"): p.get("containerPort")
                       for p in ports}
            port = None
            for name in ("grpc", "import", "http"):
                if by_name.get(name) is not None:
                    port = by_name[name]
                    break
            if port is None and ports:
                port = ports[0].get("containerPort")
            if ip and port:
                out.append(f"{ip}:{port}")
        return out
