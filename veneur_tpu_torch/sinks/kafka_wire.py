"""A from-scratch Kafka wire-protocol producer.

The reference's kafka sink is a sarama async producer
(sinks/kafka/kafka.go:109-141: ack requirement, hash/random partitioner,
retry max, flush thresholds by bytes/messages/frequency). This module
speaks the actual Kafka broker protocol so the sink produces bytes a
real broker accepts — no client library required:

* **Metadata v0** (api_key 3) to the bootstrap broker: discovers broker
  addresses and per-partition leaders.
* **Produce v1** (api_key 0) per leader: required_acks / timeout, one
  magic-1 MessageSet (CRC-32, timestamp) per topic-partition.
* **Hash partitioning** with fnv1a-32 over the message key, matching
  sarama's NewHashPartitioner, so a key lands on the same partition a
  sarama producer would pick; `random` partitioner supported.
* **Retriable-error handling**: on connection failure or a retriable
  partition error code (leader moved, etc.) the producer refreshes
  metadata and retries up to ``retry_max`` times.

Buffering matches the sink's produce semantics: ``send`` appends to a
per-(topic, partition) buffer; the buffer flushes when ``buffer_bytes``
/ ``buffer_messages`` thresholds are crossed or on an explicit
``flush()`` (the sink calls it every interval), mirroring sarama's
Flush.Bytes / Flush.Messages / Flush.Frequency triple.

Wire format notes (all integers big-endian):
  request  = int32 size, int16 api_key, int16 api_version,
             int32 correlation_id, nullable_string client_id, body
  string   = int16 length + bytes        (-1 = null)
  bytes    = int32 length + bytes        (-1 = null)
  array    = int32 count + elements
  message (magic 1) = int32 crc32-of-rest, int8 magic, int8 attrs,
             int64 timestamp_ms, bytes key, bytes value
  message_set entry = int64 offset, int32 message_size, message
"""

from __future__ import annotations

import logging
import random
import socket
import struct
import threading
import time
import zlib
from typing import Optional

log = logging.getLogger("veneur_tpu_torch.sinks.kafka_wire")

API_PRODUCE = 0
API_METADATA = 3

ACKS_NONE = 0
ACKS_LOCAL = 1
ACKS_ALL = -1

# error codes a fresh metadata fetch can fix (broker moved / catching up)
RETRIABLE_ERRORS = {
    5,   # LEADER_NOT_AVAILABLE
    6,   # NOT_LEADER_FOR_PARTITION
    7,   # REQUEST_TIMED_OUT
    8,   # BROKER_NOT_AVAILABLE
    9,   # REPLICA_NOT_AVAILABLE
    13,  # NETWORK_EXCEPTION
}


def _fnv1a32(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def enc_string(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    raw = s.encode("utf-8")
    return struct.pack(">h", len(raw)) + raw


def enc_bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _Reader:
    """Cursor over a response payload."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0

    def _take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("short kafka response")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def i16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def string(self) -> Optional[str]:
        n = self.i16()
        if n < 0:
            return None
        return self._take(n).decode("utf-8")


def encode_message(key: Optional[bytes], value: Optional[bytes],
                   timestamp_ms: int) -> bytes:
    """One magic-1 message: crc over everything after the crc field."""
    body = (struct.pack(">bbq", 1, 0, timestamp_ms)
            + enc_bytes(key) + enc_bytes(value))
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return struct.pack(">I", crc) + body


def encode_message_set(messages: list[tuple[Optional[bytes],
                                            Optional[bytes], int]]) -> bytes:
    """MessageSet: offsets are producer-side placeholders (brokers assign
    real offsets; any value is legal in produce requests)."""
    out = []
    for i, (key, value, ts) in enumerate(messages):
        msg = encode_message(key, value, ts)
        out.append(struct.pack(">qi", i, len(msg)) + msg)
    return b"".join(out)


class BrokerConnection:
    """One TCP connection to one broker; request/response framing."""

    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 10.0) -> None:
        self.host, self.port = host, port
        self.client_id = client_id
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._corr = 0

    def connect(self) -> None:
        if self.sock is not None:
            return
        self.sock = socket.create_connection((self.host, self.port),
                                             timeout=self.timeout)

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def request(self, api_key: int, api_version: int, body: bytes,
                expect_response: bool = True) -> Optional[_Reader]:
        self.connect()
        assert self.sock is not None
        self._corr += 1
        corr = self._corr
        header = (struct.pack(">hhi", api_key, api_version, corr)
                  + enc_string(self.client_id))
        frame = header + body
        self.sock.sendall(struct.pack(">i", len(frame)) + frame)
        if not expect_response:
            return None
        raw = self._read_exact(4)
        (size,) = struct.unpack(">i", raw)
        if not 0 <= size <= 100 * 1024 * 1024:
            # response sizes beyond any sane broker config mean a
            # corrupt/hostile peer; don't allocate on its say-so
            raise ValueError(f"implausible kafka response size {size}")
        payload = self._read_exact(size)
        r = _Reader(payload)
        got_corr = r.i32()
        if got_corr != corr:
            raise ValueError(
                f"correlation id mismatch: sent {corr}, got {got_corr}")
        return r

    def _read_exact(self, n: int) -> bytes:
        assert self.sock is not None
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("broker closed connection")
            buf += chunk
        return buf


class ClusterMetadata:
    def __init__(self) -> None:
        self.brokers: dict[int, tuple[str, int]] = {}
        # (topic, partition) -> leader node id
        self.leaders: dict[tuple[str, int], int] = {}
        # topic -> partition count
        self.partitions: dict[str, int] = {}


def parse_metadata_response(r: _Reader) -> ClusterMetadata:
    md = ClusterMetadata()
    for _ in range(r.i32()):
        node = r.i32()
        host = r.string() or ""
        port = r.i32()
        md.brokers[node] = (host, port)
    for _ in range(r.i32()):
        t_err = r.i16()
        topic = r.string() or ""
        nparts = r.i32()
        count = 0
        for _ in range(nparts):
            p_err = r.i16()
            pid = r.i32()
            leader = r.i32()
            for _ in range(r.i32()):  # replicas
                r.i32()
            for _ in range(r.i32()):  # isr
                r.i32()
            if t_err == 0 and p_err in (0, 9):  # 9: replica unavailable
                md.leaders[(topic, pid)] = leader
                count += 1
        if count:
            md.partitions[topic] = count
    return md


class KafkaWireProducer:
    """Buffering producer over the real broker protocol, with the
    reference sink's tuning surface (acks, retries, partitioner, flush
    thresholds). Thread-safe: sends may arrive from several span workers
    concurrently."""

    def __init__(self, brokers: str | list[str],
                 client_id: str = "veneur-tpu",
                 require_acks: str = "all",
                 retry_max: int = 3,
                 partitioner: str = "hash",
                 buffer_bytes: int = 0,
                 buffer_messages: int = 0,
                 buffer_ms: float = 0.0,
                 ack_timeout_ms: int = 10000,
                 connect_timeout: float = 10.0) -> None:
        if isinstance(brokers, str):
            brokers = [b.strip() for b in brokers.split(",") if b.strip()]
        self.bootstrap = []
        for b in brokers:
            host, _, port = b.rpartition(":")
            self.bootstrap.append((host or "127.0.0.1", int(port)))
        self.client_id = client_id
        self.acks = {"none": ACKS_NONE, "local": ACKS_LOCAL,
                     "all": ACKS_ALL}.get(require_acks, ACKS_ALL)
        self.retry_max = max(0, retry_max)
        self.partitioner = partitioner
        self.buffer_bytes = buffer_bytes
        self.buffer_messages = buffer_messages
        self.buffer_ms = buffer_ms
        self.ack_timeout_ms = ack_timeout_ms
        self.connect_timeout = connect_timeout

        # _lock guards the message buffer only (held for appends, never
        # across network I/O); _io_lock serializes every network path —
        # metadata refresh, broker connections, produce requests — so
        # concurrent send()/flush() callers can never interleave frames
        # on one socket. self._meta is replaced atomically and may be
        # READ without a lock; it is only written under _io_lock.
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        # (topic, partition) -> list of (key, value, ts_ms)
        self._buf: dict[tuple[str, int],
                        list[tuple[Optional[bytes], Optional[bytes], int]]] \
            = {}
        self._buf_bytes = 0
        self._buf_msgs = 0
        self._last_flush = time.monotonic()
        self._conns: dict[int, BrokerConnection] = {}
        self._meta: Optional[ClusterMetadata] = None
        # topic -> monotonic deadline before which we won't re-fetch
        # metadata for a topic that wasn't there (avoids a per-send
        # metadata storm against a nonexistent topic)
        self._topic_retry_at: dict[str, float] = {}
        self.delivered = 0
        self.dropped = 0

    # -- metadata ------------------------------------------------------

    def _bootstrap_conn(self) -> BrokerConnection:
        errs = []
        for host, port in self.bootstrap:
            conn = BrokerConnection(host, port, self.client_id,
                                    self.connect_timeout)
            try:
                conn.connect()
                return conn
            except OSError as e:
                errs.append(f"{host}:{port}: {e}")
        raise ConnectionError("no bootstrap broker reachable: "
                              + "; ".join(errs))

    def refresh_metadata(self, topics: list[str]) -> ClusterMetadata:
        """Fetch cluster metadata. Callers must hold _io_lock."""
        body = struct.pack(">i", len(topics)) + b"".join(
            enc_string(t) for t in topics)
        conn = self._bootstrap_conn()
        try:
            r = conn.request(API_METADATA, 0, body)
            assert r is not None
            md = parse_metadata_response(r)
        finally:
            conn.close()
        self._meta = md
        return md

    def _ensure_topic(self, topic: str) -> Optional[ClusterMetadata]:
        """Metadata containing `topic`, refreshing at most once per
        backoff window for topics the cluster doesn't have. Returns None
        when the topic is (still) unknown."""
        with self._io_lock:
            meta = self._meta
            if meta is not None and topic in meta.partitions:
                return meta  # another thread already refreshed
            now = time.monotonic()
            if now < self._topic_retry_at.get(topic, 0.0):
                return None
            try:
                meta = self.refresh_metadata([topic])
            except (OSError, ValueError, ConnectionError) as e:
                log.warning("kafka metadata refresh failed: %s", e)
                self._topic_retry_at[topic] = now + 5.0
                return None
            if topic not in meta.partitions:
                self._topic_retry_at[topic] = now + 5.0
                return None
            self._topic_retry_at.pop(topic, None)
            return meta

    def _leader_conn(self, node: int) -> BrokerConnection:
        conn = self._conns.get(node)
        if conn is None:
            assert self._meta is not None
            host, port = self._meta.brokers[node]
            conn = BrokerConnection(host, port, self.client_id,
                                    self.connect_timeout)
            self._conns[node] = conn
        return conn

    # -- partitioning --------------------------------------------------

    def _partition_for(self, meta: ClusterMetadata, topic: str,
                       key: Optional[bytes]) -> int:
        n = meta.partitions.get(topic, 0)
        if n <= 0:
            raise ValueError(f"topic {topic!r} has no available partitions")
        if self.partitioner == "random" or not key:
            return random.randrange(n)
        # sarama NewHashPartitioner: fnv1a-32 of the key, modulo partition
        # count, negative-safe (int32 wrap then abs)
        h = _fnv1a32(key)
        if h >= 1 << 31:
            h -= 1 << 32
        return abs(h) % n

    # -- the producer surface used by the sinks ------------------------

    def send(self, topic: str, key: Optional[bytes],
             value: Optional[bytes]) -> None:
        ts = int(time.time() * 1000)
        meta = self._meta  # atomic read; written only under _io_lock
        if meta is None or topic not in meta.partitions:
            meta = self._ensure_topic(topic)
            if meta is None:
                # unknown topic (backoff window active): count the drop
                # rather than stall every sender on metadata round trips
                with self._lock:
                    self.dropped += 1
                return
        part = self._partition_for(meta, topic, key)
        with self._lock:
            self._buf.setdefault((topic, part), []).append((key, value, ts))
            self._buf_msgs += 1
            self._buf_bytes += (len(key or b"") + len(value or b"") + 34)
            due = (
                (self.buffer_messages
                 and self._buf_msgs >= self.buffer_messages)
                or (self.buffer_bytes
                    and self._buf_bytes >= self.buffer_bytes)
                or (self.buffer_ms and (time.monotonic() - self._last_flush)
                    * 1000.0 >= self.buffer_ms))
            batches = self._take_buffer() if due else None
        if batches:
            self._produce(batches)

    def flush(self) -> None:
        with self._lock:
            batches = self._take_buffer()
        if batches:
            self._produce(batches)

    def close(self) -> None:
        self.flush()
        with self._io_lock:
            for conn in self._conns.values():
                conn.close()
            self._conns.clear()

    def _take_buffer(self):
        batches, self._buf = self._buf, {}
        self._buf_bytes = 0
        self._buf_msgs = 0
        self._last_flush = time.monotonic()
        return batches

    # -- produce -------------------------------------------------------

    def _produce(self, batches) -> None:
        """Send buffered message sets to their partition leaders,
        refreshing metadata and retrying retriable failures. All network
        I/O (including broker connections shared in self._conns) runs
        under _io_lock so concurrent send()/flush() callers can never
        interleave frames on a socket."""
        with self._io_lock:
            self._produce_locked(batches)

    def _produce_locked(self, batches) -> None:
        attempt = 0
        while batches and attempt <= self.retry_max:
            if attempt:
                time.sleep(min(0.1 * (2 ** (attempt - 1)), 2.0))
            failed = {}
            by_leader: dict[int, dict] = {}
            topics = sorted({t for (t, _p) in batches})
            try:
                if self._meta is None:
                    self.refresh_metadata(topics)
                for (topic, part), msgs in batches.items():
                    assert self._meta is not None
                    leader = self._meta.leaders.get((topic, part))
                    if leader is None:
                        # partition vanished: re-partition by count
                        n = self._meta.partitions.get(topic, 0)
                        if n:
                            leader = self._meta.leaders.get(
                                (topic, part % n))
                    if leader is None:
                        failed[(topic, part)] = msgs
                        continue
                    by_leader.setdefault(leader, {})[(topic, part)] = msgs
            except (OSError, ValueError) as e:
                log.warning("kafka metadata refresh failed: %s", e)
                failed = batches
                by_leader = {}

            for leader, parts in by_leader.items():
                bad = self._produce_to_leader(leader, parts)
                failed.update(bad)

            if failed:
                # force a metadata refresh before the next attempt: the
                # usual cause is a moved leader
                self._meta = None
            batches = failed
            attempt += 1
        if batches:
            lost = sum(len(m) for m in batches.values())
            self.dropped += lost
            log.warning("kafka: dropping %d messages after %d attempts",
                        lost, self.retry_max + 1)

    def _produce_to_leader(self, leader: int, parts: dict) -> dict:
        """One Produce v1 request to one broker. Returns the
        (topic, partition) -> msgs map that should be retried."""
        per_topic: dict[str, list[tuple[int, bytes, list]]] = {}
        for (topic, part), msgs in parts.items():
            per_topic.setdefault(topic, []).append(
                (part, encode_message_set(msgs), msgs))

        body = [struct.pack(">hii", self.acks, self.ack_timeout_ms,
                            len(per_topic))]
        for topic, plist in per_topic.items():
            body.append(enc_string(topic))
            body.append(struct.pack(">i", len(plist)))
            for part, mset, _msgs in plist:
                body.append(struct.pack(">ii", part, len(mset)))
                body.append(mset)
        payload = b"".join(body)

        conn = self._leader_conn(leader)
        try:
            r = conn.request(API_PRODUCE, 1, payload,
                             expect_response=self.acks != ACKS_NONE)
        except (OSError, ValueError, ConnectionError) as e:
            log.warning("kafka produce to node %d failed: %s", leader, e)
            conn.close()
            return parts
        if r is None:  # acks=none: fire and forget
            self.delivered += sum(len(m) for _, _, m in
                                  (x for pl in per_topic.values()
                                   for x in pl))
            return {}
        # Produce v1 response: topics array, then throttle_time
        retry = {}
        try:
            for _ in range(r.i32()):
                topic = r.string() or ""
                for _ in range(r.i32()):
                    part = r.i32()
                    err = r.i16()
                    r.i64()  # base_offset
                    msgs = parts.get((topic, part))
                    if msgs is None:
                        continue
                    if err == 0:
                        self.delivered += len(msgs)
                    elif err in RETRIABLE_ERRORS:
                        retry[(topic, part)] = msgs
                    else:
                        self.dropped += len(msgs)
                        log.warning(
                            "kafka: fatal error %d for %s[%d]; dropping"
                            " %d messages", err, topic, part, len(msgs))
        except ValueError as e:
            log.warning("kafka: bad produce response from node %d: %s",
                        leader, e)
            conn.close()
            return parts
        return retry
