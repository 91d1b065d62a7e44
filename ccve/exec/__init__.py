"""L4 executors: pipelined (chunk-at-a-time), bulk (operator-at-a-time),
and the NumPy oracle (reference L4; SURVEY.md §3)."""

from ccve.exec.bulk import bulk_count, bulk_materialize, match_stats
from ccve.exec.oracle import oracle_join, oracle_pipeline
from ccve.exec.pipeline import JoinPipeline

__all__ = [
    "JoinPipeline",
    "bulk_count",
    "bulk_materialize",
    "match_stats",
    "oracle_join",
    "oracle_pipeline",
]
