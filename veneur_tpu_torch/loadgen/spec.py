"""Declarative workload spec for the wire-rate load generator.

The spec is the single description of synthesized traffic shape —
metric-type mix, Zipf-distributed key cardinality, tag shape, datagram
packing — shared by tools/port_bench_sustained.py, chip_smoke.py's
phase 17 and the tests. Ring synthesis itself happens in C++
(native/loadgen.cpp vn_lg_ring_synth); SSF rings are built here once at
setup time via the generated protobuf (the per-packet send path never
re-enters Python either way).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

from veneur_tpu_torch import native

if TYPE_CHECKING:
    from veneur_tpu_torch.core.config import Config


@dataclass
class WorkloadSpec:
    seed: int = 7
    num_keys: int = 10000
    zipf_s: float = 1.1  # 0 = uniform key popularity
    # weights over the fixed type order {c, g, ms, h, s}
    type_mix: list[float] = field(
        default_factory=lambda: [0.35, 0.15, 0.25, 0.15, 0.10])
    num_tags: int = 3
    tag_cardinality: int = 50
    prefix: str = "lg"
    datagram_bytes: int = 1400
    ring_lines: int = 200000
    # multi-tenant dimension (per-tenant QoS soak): tenant_count > 1
    # stamps every line with a trailing tenant:tN tag. The LAST tenant
    # is the abusive one — tenant_abusive_frac of lines go to it and
    # its key space churns over tenant_churn_keys names beyond
    # num_keys (the cardinality attack the series budget defends
    # against); innocents draw Zipf(tenant_zipf_s; 0 = uniform) over
    # the remaining ids. 1 emits byte-identical single-tenant output.
    tenant_count: int = 1
    tenant_abusive_frac: float = 0.0
    tenant_zipf_s: float = 0.0
    tenant_churn_keys: int = 0

    @classmethod
    def from_config(cls, cfg: "Config") -> "WorkloadSpec":
        return cls(
            seed=cfg.loadgen_seed,
            num_keys=cfg.loadgen_num_keys,
            zipf_s=cfg.loadgen_zipf_s,
            type_mix=list(cfg.loadgen_type_mix),
            num_tags=cfg.loadgen_num_tags,
            tag_cardinality=cfg.loadgen_tag_cardinality,
            prefix=cfg.loadgen_prefix,
            datagram_bytes=cfg.loadgen_datagram_bytes,
            ring_lines=cfg.loadgen_ring_lines,
            tenant_count=cfg.loadgen_tenant_count,
            tenant_abusive_frac=cfg.loadgen_tenant_abusive_frac,
            tenant_zipf_s=cfg.loadgen_tenant_zipf_s,
            tenant_churn_keys=cfg.loadgen_tenant_churn_keys,
        )

    def validate(self) -> None:
        if not (1 <= self.num_keys <= (1 << 24)):
            raise ValueError("num_keys must be in [1, 2^24]")
        if self.zipf_s < 0:
            raise ValueError("zipf_s must be >= 0")
        if (len(self.type_mix) != len(native.LOADGEN_TYPES)
                or any(w < 0 for w in self.type_mix)
                or sum(self.type_mix) <= 0):
            raise ValueError("type_mix must be 5 non-negative weights"
                             " with a positive sum")
        if not (0 <= self.num_tags <= 16):
            raise ValueError("num_tags must be in [0,16]")
        if self.tag_cardinality < 1:
            raise ValueError("tag_cardinality must be >= 1")
        if not (64 <= self.datagram_bytes <= 65507):
            raise ValueError("datagram_bytes must fit a UDP datagram")
        if self.ring_lines < 1:
            raise ValueError("ring_lines must be >= 1")
        if not self.prefix:
            raise ValueError("prefix must be non-empty")
        if not (1 <= self.tenant_count <= 4096):
            raise ValueError("tenant_count must be in [1, 4096]")
        if not (0.0 <= self.tenant_abusive_frac <= 1.0):
            raise ValueError("tenant_abusive_frac must be in [0,1]")
        if self.tenant_zipf_s < 0:
            raise ValueError("tenant_zipf_s must be >= 0")
        if self.tenant_churn_keys < 0:
            raise ValueError("tenant_churn_keys must be >= 0")

    def to_dict(self) -> dict:
        return {
            "seed": self.seed, "num_keys": self.num_keys,
            "zipf_s": self.zipf_s, "type_mix": list(self.type_mix),
            "num_tags": self.num_tags,
            "tag_cardinality": self.tag_cardinality,
            "prefix": self.prefix, "datagram_bytes": self.datagram_bytes,
            "ring_lines": self.ring_lines,
            "tenant_count": self.tenant_count,
            "tenant_abusive_frac": self.tenant_abusive_frac,
            "tenant_zipf_s": self.tenant_zipf_s,
            "tenant_churn_keys": self.tenant_churn_keys,
        }

    def build_ring(self) -> "native.LoadgenRing":
        """Synthesize the DogStatsD send ring in C++ (deterministic for
        a given spec: same spec → same content hash)."""
        self.validate()
        ring = native.LoadgenRing()
        ring.synth(self.seed, self.num_keys, self.zipf_s, self.type_mix,
                   self.num_tags, self.tag_cardinality,
                   self.prefix.encode("utf-8"), self.datagram_bytes,
                   self.ring_lines,
                   tenant_count=self.tenant_count,
                   tenant_abusive_frac=self.tenant_abusive_frac,
                   tenant_zipf_s=self.tenant_zipf_s,
                   tenant_churn_keys=self.tenant_churn_keys)
        return ring

    def build_ssf_ring(self, n_spans: int = 2000) -> "native.LoadgenRing":
        """SSF span ring: payloads built ONCE here via the generated
        protobuf (one span per datagram), then cycled by the C++ sender
        — setup cost is Python, the send path is not."""
        self.validate()
        from veneur_tpu_torch.gen import ssf_pb2

        rng = random.Random(self.seed)
        ring = native.LoadgenRing()
        services = ["api", "db", "web", "worker"]
        for i in range(n_spans):
            pb = ssf_pb2.SSFSpan()
            pb.trace_id = rng.randrange(1, 1 << 62)
            pb.id = rng.randrange(1, 1 << 62)
            pb.parent_id = rng.randrange(1, 1 << 62)
            pb.start_timestamp = 10**9 + i * 1000
            pb.end_timestamp = pb.start_timestamp + rng.randrange(
                10**5, 10**8)
            pb.service = services[i % len(services)]
            pb.name = "%s.span%d" % (self.prefix,
                                     rng.randrange(self.num_keys))
            pb.indicator = (i % 10) == 0
            pb.error = (i % 17) == 0
            pb.tags["host"] = "h%d" % (i % 8)
            m = pb.metrics.add()
            m.metric = ssf_pb2.SSFSample.COUNTER
            m.name = "%s.ssf.hits" % self.prefix
            m.value = 1.0
            m.sample_rate = 1.0
            ring.append(pb.SerializeToString(), lines=1)
        return ring
