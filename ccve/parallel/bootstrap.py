"""Multi-process bootstrap — the engine's NCCL-backend equivalent.

The reference is a single process with zero distributed machinery
(SURVEY.md §2 parallelism inventory); SURVEY §5 names
`jax.distributed.initialize` as the layer that replaces an NCCL/MPI
backend. This module is that layer: one entry point that wires a process
into the JAX distributed runtime (coordinator handshake; Gloo collectives
on CPU, NCCL on GPUs), builds the global join mesh, and runs the
distributed join harness across every process's devices.

Launch (one command per process):

    CCVE_COORDINATOR=host0:9731 CCVE_NUM_PROCESSES=2 CCVE_PROCESS_ID=0 \
        python -m ccve.cli dist --n-build 100000 --n-probe 1000000
    CCVE_COORDINATOR=host0:9731 CCVE_NUM_PROCESSES=2 CCVE_PROCESS_ID=1 \
        python -m ccve.cli dist ...

or with explicit flags (--coordinator/--num-processes/--process-id).
Nothing detects a cluster: the coordinator, process count and process id
are always given. Multi-process mode is for several hosts, one process
per host over all of its devices. Several processes on ONE host must
each be given their own devices (`--local-device-ids`, or
CUDA_VISIBLE_DEVICES), since a JAX process reserves most of every card's
memory it opens; one process over all of a host's cards (no coordinator)
is the usual single-host run. Smoke-tested in CI with a real 2-process
CPU launch (tests/test_bootstrap.py): psum / all_to_all ride Gloo across
processes, so the whole radix-shuffle path is exercised cross-PROCESS,
not just cross-device.

Multi-process placement notes (why this works with the existing
`parallel/distributed.py` unchanged): every process calls the harness
with the SAME host-side inputs (deterministic generators), and
`jax.device_put(host_array, NamedSharding(...))` in a multi-process
program places only the caller's addressable shards — the documented
multi-host pattern for identical-everywhere host data. Outputs of the
shard_map are replicated (out_specs P()), so every process reads the
same count without extra collectives.
"""

from __future__ import annotations

import os
import time


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> dict:
    """Join the JAX distributed runtime.

    Argument > env (CCVE_COORDINATOR / CCVE_NUM_PROCESSES /
    CCVE_PROCESS_ID). With no coordinator anywhere and num_processes in
    {None, 1}, this is the single-process run: nothing is initialized
    and the harness runs on all local devices. `local_device_ids` limits
    this process to those local devices (several processes on one
    host)."""
    import jax

    coordinator = coordinator or os.environ.get("CCVE_COORDINATOR")
    if num_processes is None and os.environ.get("CCVE_NUM_PROCESSES"):
        num_processes = int(os.environ["CCVE_NUM_PROCESSES"])
    if process_id is None and os.environ.get("CCVE_PROCESS_ID"):
        process_id = int(os.environ["CCVE_PROCESS_ID"])

    if coordinator is None and (num_processes is None or num_processes == 1):
        return {
            "initialized": False,
            "process_id": 0,
            "num_processes": 1,
        }

    extra = {}
    if local_device_ids is not None:
        extra["local_device_ids"] = local_device_ids
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
        **extra,
    )
    return {
        "initialized": True,
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
    }


def run_dist_join(
    n_build: int = 100_000,
    n_probe: int = 1_000_000,
    n_joins: int = 1,
    kind: str = "sorted",
    pipeline_levels: int = 0,
    cross_check: bool | None = None,
    hierarchical: bool | None = None,
    zipf_alpha: float | None = None,
    shuffle: str | None = None,
) -> dict:
    """The distributed-join harness over the GLOBAL device mesh
    (config-5 geometry by default): deterministic tables + probe
    (identical on every process), hash-partitioned build, radix-shuffle
    probe, factorized count. With `pipeline_levels` > 0 also runs the
    N-level materializing `dist_pipeline_expand` on a probe subset.

    `cross_check` (default: only when single-process) re-counts on one
    device and asserts equality — cross-process runs skip it because a
    single-device count would need all shards on one host.

    `hierarchical` (default: auto — on when the launch really is
    multi-process with >1 local device per process) uses the 2D
    (dcn, ici) mesh whose LEADING axis is the process boundary — the
    genuine cross-host link — and the 2-hop shuffle
    (`dist_bulk_count_hier`): an intra-process hop to the owner's chip
    column, then every key crosses the slow axis exactly once inside a
    host-aggregated grid, landing directly at its owner.

    `shuffle` overrides the plan outright: "flat" / "hier" map onto
    `hierarchical`; "bcast" replicates the build tables to every device
    (`dist_bulk_count_bcast`) so the probe stream never crosses the
    mesh — the amortized plan for small builds (bench/dist_model.py
    prices the crossover). PRPD/zipf composes with bcast trivially:
    replication IS total heavy-hitter duplication, so the skew path is
    simply unnecessary there."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ccve.core.datagen import gen_probe_table, gen_rhs_table
    from ccve.parallel.distributed import (
        dist_bulk_count,
        dist_bulk_count_hier,
        make_join_mesh,
        make_join_mesh_2d,
        partition_tables,
    )

    n_devices = len(jax.devices())
    n_local = len(jax.local_devices())
    n_procs = jax.process_count()
    if cross_check is None:
        cross_check = n_procs == 1
    if shuffle == "flat":
        hierarchical = False
    elif shuffle == "hier":
        hierarchical = True
    if hierarchical is None:
        hierarchical = shuffle != "bcast" and n_procs > 1 and n_local > 1

    keys, payloads = gen_rhs_table(n_build, 1)
    if zipf_alpha is not None:
        # skewed workload: Zipf-distributed probe keys + PRPD — detect
        # the Zipf head on a probe sample, replicate those build rows to
        # every shard, shuffle only the cold tail (the head neither
        # loads one partition nor counts toward send capacity)
        from ccve.core.datagen import gen_zipf_keys
        from ccve.parallel.distributed import (
            detect_heavy_hitters,
            partition_tables_split,
        )

        probe = np.stack(
            [
                gen_zipf_keys(n_probe, n_build, zipf_alpha, seed=11 + j)
                for j in range(n_joins)
            ],
            axis=1,
        ).astype(np.int64)
        hot = detect_heavy_hitters(probe[: min(n_probe, 262_144)])
    else:
        probe = gen_probe_table(n_probe, n_joins, n_build)
        hot = None

    if shuffle == "bcast":
        from ccve.parallel.distributed import (
            dist_bulk_count_bcast,
            replicate_tables,
        )

        hierarchical = False
        mesh = (
            make_join_mesh_2d(n_procs, n_devices // n_procs)
            if n_procs > 1 and n_local > 1
            else make_join_mesh(n_devices)
        )
        rtables = [
            replicate_tables(keys, payloads, kind, mesh)
            for _ in range(n_joins)
        ]

        def counter(mesh, _ptables, probe, **_kw):
            return dist_bulk_count_bcast(mesh, rtables, probe)

    elif hierarchical:
        if zipf_alpha is not None:
            raise ValueError(
                "PRPD (zipf) runs on the flat shuffle; pass "
                "hierarchical=False / --shuffle flat"
            )
        mesh = make_join_mesh_2d(n_procs, n_devices // n_procs)
        counter = dist_bulk_count_hier
    else:
        mesh = make_join_mesh(n_devices)
        counter = dist_bulk_count
    if shuffle == "bcast":
        ptables = None
    elif hot is not None and hot.size:
        ptables = [
            partition_tables_split(
                keys, payloads, n_devices, hot, kind, mesh
            )
            for _ in range(n_joins)
        ]
    else:
        ptables = [
            partition_tables(keys, payloads, n_devices, kind, mesh)
            for _ in range(n_joins)
        ]

    t0 = time.perf_counter()
    res = counter(mesh, ptables, probe)
    count = int(res.count)  # the readback is the sync
    seconds = time.perf_counter() - t0

    out = {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "n_devices": n_devices,
        "hierarchical": bool(hierarchical),
        "shuffle": shuffle
        or ("hier" if hierarchical else "flat"),
        "n_build": n_build,
        "n_probe": n_probe,
        "n_joins": n_joins,
        "count": count,
        "rows_per_s": n_probe / seconds,
        "seconds": seconds,
        "skew": float(res.skew),
        "overflow": bool(res.overflow),
    }

    if cross_check:
        from ccve.exec.bulk import bulk_count
        from ccve.ops.hash_table import build_csr, build_lp
        from ccve.ops.sort_merge import build_sorted

        builder = {
            "sorted": build_sorted,
            "lp": build_lp,
            "csr": build_csr,
        }[kind]
        table = builder(keys, payloads)
        ref = bulk_count([table] * n_joins, probe)
        assert int(ref.count) == count, (int(ref.count), count)
        out["cross_checked"] = True

    if pipeline_levels > 0:
        from ccve.parallel.distributed import dist_pipeline_expand

        # the materializing pipeline shuffles on the flat 1D mesh
        pmesh = (
            make_join_mesh(n_devices)
            if len(mesh.devices.shape) > 1
            else mesh
        )
        levels = [
            partition_tables(keys, payloads, n_devices, "sorted", pmesh)
            for _ in range(pipeline_levels)
        ]
        sub = probe[: min(n_probe, 8192), :pipeline_levels]
        if sub.shape[1] < pipeline_levels:
            sub = np.concatenate(
                [sub]
                + [sub[:, :1]] * (pipeline_levels - sub.shape[1]),
                axis=1,
            )
        pres = dist_pipeline_expand(pmesh, levels, sub)
        out["pipeline_rows"] = int(pres.total)
        out["pipeline_overflow"] = bool(pres.overflow)
    return out
