"""Multi-chip tier: hash-partitioned joins over a jax.sharding.Mesh.

No reference counterpart (the C++ codebase is single-thread, SURVEY.md §2);
this is the scaling axis BASELINE.json's north star mandates.
"""

from ccve.parallel.distributed import (
    PartitionedTables,
    ReplicatedTables,
    dist_bulk_count,
    dist_bulk_count_bcast,
    make_join_mesh,
    partition_tables,
    replicate_tables,
)

__all__ = [
    "PartitionedTables",
    "ReplicatedTables",
    "dist_bulk_count",
    "dist_bulk_count_bcast",
    "make_join_mesh",
    "partition_tables",
    "replicate_tables",
]
