"""S3 plugin: upload each flush as a gzipped TSV object.

Parity: reference plugins/s3/s3.go — per-flush PUT of the TSV under
<hostname>/<timestamp>.tsv.gz. AWS SigV4 request signing is implemented
directly over stdlib (no SDK in this environment); the HTTP opener is
injectable for tests.
"""

from __future__ import annotations

import datetime
import gzip
import hashlib
import hmac
import logging
import urllib.parse
import urllib.request

from veneur_tpu_torch.plugins import Plugin, encode_inter_metrics_tsv
from veneur_tpu_torch.utils.http import default_opener

log = logging.getLogger("veneur_tpu_torch.plugins.s3")


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def _canonical_query(query: str) -> str:
    """RFC-3986 canonical query string: each name and value URI-encoded
    (unreserved chars kept), pairs sorted by name then value, valueless
    params rendered ``name=`` (the documented GET-bucket-lifecycle
    example)."""
    if not query:
        return ""
    pairs = []
    for part in query.split("&"):
        name, _, value = part.partition("=")
        pairs.append((urllib.parse.quote(name, safe="-_.~"),
                      urllib.parse.quote(value, safe="-_.~")))
    return "&".join(f"{n}={v}" for n, v in sorted(pairs))


def sigv4_headers(method: str, host: str, path: str, region: str,
                  access_key: str, secret_key: str, payload: bytes,
                  now: datetime.datetime | None = None, query: str = "",
                  extra_headers: dict[str, str] | None = None
                  ) -> dict[str, str]:
    """AWS Signature Version 4 for S3, pinned against the documented AWS
    signing examples (tests/test_plugins.py): canonical URI encoding,
    canonical query strings, and arbitrary extra signed headers. The
    returned dict carries everything the request must send (including
    the extra headers), minus Host — the transport sets that."""
    t = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = t.strftime("%Y%m%dT%H%M%SZ")
    datestamp = t.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload).hexdigest()

    headers = {
        "host": host,
        "x-amz-content-sha256": payload_hash,
        "x-amz-date": amz_date,
    }
    for k, v in (extra_headers or {}).items():
        headers[k.lower()] = str(v).strip()
    names = sorted(headers)
    canonical_headers = "".join(f"{n}:{headers[n]}\n" for n in names)
    signed_headers = ";".join(names)
    canonical_uri = urllib.parse.quote(path, safe="/-_.~")
    canonical_request = "\n".join([
        method, canonical_uri, _canonical_query(query),
        canonical_headers, signed_headers, payload_hash,
    ])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    k = _sign(("AWS4" + secret_key).encode(), datestamp)
    k = _sign(k, region)
    k = _sign(k, "s3")
    k = _sign(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    out = {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={access_key}/{scope},"
            f" SignedHeaders={signed_headers}, Signature={signature}"
        ),
    }
    for k, v in (extra_headers or {}).items():
        out.setdefault(k, str(v).strip())
    return out


class S3Plugin(Plugin):
    def __init__(self, bucket: str, region: str, access_key: str,
                 secret_key: str, interval_s: float = 10.0,
                 opener=default_opener) -> None:
        self.bucket = bucket
        self.region = region
        self.access_key = access_key
        self.secret_key = secret_key
        self.interval_s = interval_s
        self.opener = opener
        self.flush_errors = 0
        self.uploads = 0

    def name(self) -> str:
        return "s3"

    def flush(self, metrics, hostname: str) -> None:
        data = gzip.compress(
            encode_inter_metrics_tsv(metrics, hostname, self.interval_s))
        now = datetime.datetime.now(datetime.timezone.utc)
        key = f"{hostname}/{now.strftime('%Y%m%d%H%M%S')}.tsv.gz"
        host = f"{self.bucket}.s3.{self.region}.amazonaws.com"
        path = f"/{key}"
        headers = sigv4_headers("PUT", host, path, self.region,
                                self.access_key, self.secret_key, data, now)
        headers["Content-Type"] = "application/gzip"
        req = urllib.request.Request(
            f"https://{host}{path}", data=data, method="PUT",
            headers=headers)
        try:
            self.opener(req, 30.0)
            self.uploads += 1
        except Exception as e:
            self.flush_errors += 1
            log.warning("s3 upload failed: %s", e)
