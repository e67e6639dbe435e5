"""Collective statistics for the dry run's roofline (port of
`repro.launch.hlo_stats`).

The reference parses the partitioned HLO text of a compiled step: every
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute contributes its result-shape bytes, and its ring
model turns them into link traffic.  The port has no HLO: its dry run
(`launch.dryrun`) runs one rank's step on a `launch.mesh.RecordingMesh`,
whose collectives log (op, result bytes, group size), and
`collective_stats` folds that log into the same `CollectiveStats`.
`DTYPE_BYTES` and the ring model are the reference's.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, Tuple

__all__ = ["CollectiveStats", "collective_stats", "DTYPE_BYTES"]

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2,
    "f8e5m2": 1, "f8e4m3fn": 1, "f8e4m3": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}


@dataclasses.dataclass
class CollectiveStats:
    per_op_bytes: Dict[str, int]           # op kind -> sum of result bytes
    per_op_count: Dict[str, int]
    per_op_group: Dict[str, float]         # op kind -> mean group size
    total_result_bytes: int

    def link_traffic_bytes(self) -> float:
        """Per-device bytes crossing links, ring-algorithm model:
        all-reduce moves 2(n-1)/n x result bytes; all-gather and
        reduce-scatter (n-1)/n x the larger buffer; all-to-all (n-1)/n;
        collective-permute 1x."""
        total = 0.0
        for op, b in self.per_op_bytes.items():
            n = max(self.per_op_group.get(op, 2.0), 2.0)
            if op == "all-reduce":
                total += 2.0 * (n - 1) / n * b
            elif op in ("all-gather", "reduce-scatter", "all-to-all"):
                total += (n - 1) / n * b
            else:  # collective-permute (a barrier carries no bytes)
                total += b
        return total


def collective_stats(records: Iterable[Tuple[str, int, int]]
                     ) -> CollectiveStats:
    """`CollectiveStats` of a collective log: (op kind, result bytes,
    group size) per collective, as `RecordingMesh` and
    `launch.mesh.collective_log` record them."""
    per_bytes: Dict[str, int] = defaultdict(int)
    per_count: Dict[str, int] = defaultdict(int)
    group_sum: Dict[str, float] = defaultdict(float)
    for op, nbytes, group in records:
        per_bytes[op] += int(nbytes)
        per_count[op] += 1
        group_sum[op] += group
    per_group = {op: group_sum[op] / per_count[op] for op in per_count}
    return CollectiveStats(dict(per_bytes), dict(per_count), per_group,
                           sum(per_bytes.values()))
