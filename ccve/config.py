"""Engine configuration.

Replaces the reference's two-level config system — compile-time `#ifdef`
strategy flags (setting.h:17-29) and mutable inline globals
(base.h:37-51, mutated by hand-rolled argv parsing in main.cpp:202-243 and
simd_micro_bench.cpp:35-73) — with a single runtime dataclass. The strategy
axis is a runtime enum instead of one binary per strategy
(build_versions.sh:17-43).
"""

from __future__ import annotations

import dataclasses
import enum


class CompactionStrategy(enum.Enum):
    """Chunk-compaction strategy for under-filled selection vectors.

    Mirrors setting.h:17-29. The reference repo only ships NaiveCompactor
    (full compaction); `BINARY` and `DYNAMIC` are declared there but live in
    the parent repo — here all four are first-class:

    - NONE:    chunks flow downstream as-is (no compaction).
    - FULL:    always merge under-filled chunks into a cached chunk, emit
               only full chunks (NaiveCompactor, compactor.cpp:5-41).
    - BINARY:  compact only when count < block_size // 2.
    - DYNAMIC: compact when count < threshold, threshold chosen per pipeline
               level by a UCB1-tuned multi-armed bandit
               (negative_feedback.hpp:20-260).
    """

    NONE = "no_compaction"
    FULL = "full_compaction"
    BINARY = "binary_compaction"
    DYNAMIC = "dynamic_compaction"


class PayloadMode(enum.Enum):
    """What the join emits for the build side.

    REFERENCE: bit-parity with the reference's observable output. The
      reference discards build payloads (only the key is inserted into the
      bucket, chaining_ht.cpp:34, linear_probing_ht.cpp:35) and 'gathers' the
      matched key as the payload (chaining_ht.cpp:132); the first RHS output
      column is never written and stays 0. So each join level contributes
      columns (0, matched_key).
    FULL: the meaningful extension — the hash table stores real payloads
      (payload = row_index + 10_000_000, chaining_ht.cpp:21) and each level
      contributes (matched_key, matched_payload).
    """

    REFERENCE = "reference"
    FULL = "full"


# Threshold arms for the DYNAMIC strategy's bandit
# (negative_feedback.hpp:172).
DEFAULT_THRESHOLD_ARMS = (0, 32, 64, 128, 256, 384, 512, 768, 1024)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """All engine knobs. Defaults mirror base.h:37-51 except block_size
    (the reference's kBlockSize=256<<kScale): 2048 rows per chunk, so
    each of the executor's per-chunk device ops has enough rows to be
    worth its launch."""

    # Data-model geometry (base.h:42): rows per chunk, a multiple of 128
    # (the reference's 256 << kScale family, halved at the bottom).
    block_size: int = 2048

    # Query setting (base.h:48-51).
    n_joins: int = 3
    lhs_size: int = 20_000_000
    rhs_size: int = 2_000_000
    chunk_factor: int = 1

    # Micro-bench knobs (base.h:42-45, simd_micro_bench.cpp:62-63).
    hit_freq: int = 1

    strategy: CompactionStrategy = CompactionStrategy.NONE
    payload_mode: PayloadMode = PayloadMode.REFERENCE

    # Whether the result collector materializes joined tuples
    # (setting.h:31 `flag_collect_tuples`; default false there too).
    collect_tuples: bool = False

    # Whether the executor records per-level emitted-chunk occupancy
    # histograms on device (the ZebraProfiler data). The reference ships
    # with its ZebraProfiler compiled OUT (`kEnableProfiling = 0`,
    # profiler.h:170), so timed runs default to off here too — the
    # histogram update is a scatter inside the latency-bound work loop.
    record_occupancy: bool = False

    # Executor A/B: route the work loop's descend through a real
    # lax.cond so a compactor-absorbed step (emitted.count == 0 — about
    # half of all steps under FULL compaction) skips the densify-gather
    # and next-level probe at runtime, instead of computing them and
    # select-discarding. Default ON.
    branchy_descend: bool = True

    # DYNAMIC-strategy bandit arms (negative_feedback.hpp:172).
    threshold_arms: tuple = DEFAULT_THRESHOLD_ARMS

    # Per-LEVEL static compaction thresholds — a capability the
    # reference's one-compactor-class-per-binary build cannot express
    # (setting.h:17-29 fixes ONE strategy for every pipeline level).
    # When set (len == n_joins), FULL/BINARY use these instead of the
    # uniform strategy threshold, and a level with threshold 0 skips
    # the compactor at TRACE time — the heterogeneous optimum the
    # DYNAMIC tuner searches for, pinned statically.
    compact_threshold_per_level: tuple | None = None

    # DYNAMIC tuner placement: False = host bandit between segment
    # dispatches (the reference's structure, one host read per
    # segment); True = the whole bandit runs ON DEVICE inside one
    # dispatch (control/device_bandit.py), rewarded by per-level
    # work-loop step counts — zero host syncs, true per-level credit.
    device_tuner: bool = False

    # How many input chunks to process per jitted device dispatch when the
    # DYNAMIC strategy needs host-side bandit decisions between segments.
    tuner_segment_chunks: int = 64

    # Device-tuner convergence knobs (control/device_bandit.py). The
    # reference warm-starts each arm kStartSampling=4 times
    # (negative_feedback.hpp:37-45); the device tuner's occupancy reward
    # is far less noisy than the reference's wall-clock reward, so 2
    # rounds suffice — and once the greedy arm has been stable for
    # `bandit_commit_after` consecutive segment updates the level
    # COMMITS (pure exploit; uncommitted again only by the heartbeat
    # change detector). 0 disables early commit.
    bandit_start_sampling: int = 2
    bandit_commit_after: int = 8

    def __post_init__(self):
        if self.block_size % 128 != 0:
            raise ValueError(
                f"block_size must be a multiple of 128 (got {self.block_size})"
            )
        if self.n_joins < 1:
            raise ValueError("n_joins must be >= 1")
        if self.chunk_factor < 1:
            raise ValueError("chunk_factor must be >= 1")
        if self.compact_threshold_per_level is not None:
            t = self.compact_threshold_per_level
            if len(t) != self.n_joins:
                raise ValueError(
                    "compact_threshold_per_level needs one entry per join"
                    f" level (got {len(t)}, n_joins={self.n_joins})"
                )
            if self.strategy in (
                CompactionStrategy.NONE,
                CompactionStrategy.DYNAMIC,
            ):
                raise ValueError(
                    "compact_threshold_per_level applies to static"
                    " compacting strategies (FULL/BINARY) only"
                )

    @property
    def resolved_threshold_arms(self) -> tuple:
        """Bandit arms scaled to the block size. The reference's literal
        arm list (negative_feedback.hpp:172) tops out at 1024 — fractions
        of its own kBlockSize family — so at the default block 2048
        it cannot express FULL compaction (threshold == block) at all:
        the bandit's best reachable arm is BINARY. When the default list
        is in use and the block is larger than its top arm, re-scale the
        same fractions to the block; custom arm tuples pass verbatim."""
        if self.threshold_arms != DEFAULT_THRESHOLD_ARMS:
            return self.threshold_arms
        if self.block_size <= 1024:
            return self.threshold_arms
        b = self.block_size
        return (
            0, b // 32, b // 16, b // 8, b // 4, 3 * b // 8, b // 2,
            3 * b // 4, b,
        )

    @property
    def compact_threshold(self) -> int:
        """Static compaction threshold for non-DYNAMIC strategies: a chunk
        with count < threshold gets compacted into the cache."""
        if self.strategy is CompactionStrategy.NONE:
            return 0
        if self.strategy is CompactionStrategy.FULL:
            return self.block_size
        if self.strategy is CompactionStrategy.BINARY:
            return self.block_size // 2
        raise ValueError("DYNAMIC threshold comes from the tuner, not config")
