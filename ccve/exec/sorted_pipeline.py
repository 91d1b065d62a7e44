"""Sorted-chunk pipelined executor — chunk-at-a-time over sorted tables.

`exec/pipeline.JoinPipeline` is the PARITY executor: it reproduces the
reference's per-row cursor chase (`ScanStructure`/`LPScanStructure`
stepping, chaining_ht.cpp:138-173) one `Next` per work-loop iteration,
a chain of [block]-wide ops per match round. This module runs the same
chunk-at-a-time semantics over sorted tables — the relationship
sort-merge has to hash-probe on the bulk side:

 - each level's build side is a SORTED table (ops/sort_merge.SortedTable);
 - a probe row's match count and first-match position against a level —
   its RANK (mult, start) — depend only on the row's key value for that
   level, never on which chunk the row currently rides in. The reference
   exploits nothing of the sort (its Probe runs per emitted chunk,
   chaining_ht.cpp:38-58); here the ranks for ALL levels are computed in
   one segment-batched sort-merge stats pass per level (rank_mode
   "batched", ops/sort_merge.sorted_match_ranks — the bulk engine's
   sort-merge stats) and carried as extra int64 RANK COLUMNS
   (mult << 32 | start) that ride the chunk stream, the compactor caches
   and the flush cascade like any other column. The per-chunk per-level
   work left in the executor is the reference's actual chunk-at-a-time
   control: the drain over match ranks, compaction, and the descend;
 - rank_mode "chunk" is the fully-streaming formulation (nothing
   precomputed per segment): each (chunk, level) ranks its keys by
   binary search on the sorted table (`chunk_rank`). The batched mode
   is the default;
 - the drain over match ranks t = 0..max_mult-1 REPLAYS the reference's
   emission structure: drain step t emits the rows with more than t
   matches (the rows the reference's t-th `Next` call would emit), so
   chunk-at-a-time compaction semantics — including the NONE/FULL/BINARY/
   DYNAMIC strategies and the end-of-stream flush cascade — are preserved
   and the emitted multiset matches `exec/oracle.oracle_pipeline` exactly.

The executor recursion over levels is STATIC (Python-unrolled, like the
reference's template recursion); the per-level drain is a
`lax.fori_loop` over the table's static max-multiplicity, so there is no
data-dependent `while_loop` and no `lax.switch` — every chunk flows
through one straight-line compiled program.

Row order inside emitted chunks differs from the reference (rows are
emitted in input-storage order per drain rank, not per bucket-chain
position), which is invisible in the result multiset the reference
itself checks (#tuples cross-checks, simd_micro_bench.cpp:116).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from ccve.config import CompactionStrategy, PayloadMode
from ccve.core.chunk import Chunk, compact_rows, iota_sel
from ccve.exec.pipeline import JoinPipeline
from ccve.ops import compactor as comp
from ccve.ops.sort_merge import (
    SortedTable,
    rank_table,
    sorted_match_ranks,
)


def chunk_rank(table_keys: jax.Array, keys: jax.Array, valid: jax.Array):
    """(mult, start) int32[block] per probe lane, in lane order: binary
    search of the raw int64 keys in the sorted table. `start` indexes
    the SORTED table (garbage where mult == 0); invalid lanes get mult
    0."""
    start = jnp.searchsorted(table_keys, keys, side="left").astype(jnp.int32)
    end = jnp.searchsorted(table_keys, keys, side="right").astype(jnp.int32)
    mult = jnp.where(valid, end - start, 0).astype(jnp.int32)
    return mult, start


class SortedPipeline(JoinPipeline):
    """Chunk-at-a-time N-way join over per-level SORTED tables.

    rank_mode:
      - "batched" (default): per-segment rank precompute carried as rank
        columns (see module docstring).
      - "chunk": per-(chunk, level) binary-search ranks (`chunk_rank`).
    """

    def __init__(
        self,
        tables: Sequence[SortedTable],
        config,
        result_capacity: int | None = None,
        prefilter=None,
        prefilter_col: int = 0,
        rank_mode: str = "batched",
    ):
        for t in tables:
            if not isinstance(t, SortedTable):
                raise TypeError("SortedPipeline needs SortedTable levels")
        if rank_mode not in ("batched", "chunk"):
            raise ValueError(f"unknown rank_mode {rank_mode!r}")
        self.rank_mode = rank_mode
        self._fanout = [max(t.max_mult, 1) for t in tables]
        super().__init__(
            tables,
            config,
            result_capacity=result_capacity,
            prefilter=prefilter,
            prefilter_col=prefilter_col,
            lanes=1,
        )
        # every chunk this executor emits/caches/flushes has identity
        # sel (core/chunk.compact_rows) — _collect skips its gather
        self._dense_chunks = True
        if rank_mode == "batched":
            # rank-index twins (payload = sorted row index) + one int64
            # rank column per level, appended past the result columns;
            # they ride the compactor caches / flush like data columns
            # but are stripped at _collect (result_width)
            self._rank_tables = [rank_table(t) for t in tables]
            self._rank_col0 = self.width
            self.width += self.n_levels

    # ------------------------------------------------------------------

    def _seg_ranks(self, chunk_cols: jax.Array) -> jax.Array:
        """Batched rank precompute for one segment of chunks.

        chunk_cols: int64[S, n_joins, block] → int64[S, n_levels, block]
        rank columns, rank = mult << 32 | start (start indexes the SORTED
        table). One `sorted_match_ranks` pass per level over the FLAT
        S*block key stream — the whole segment's probe work for a level
        is one sort-merge, instead of one rank pass per chunk
        (rank_mode="chunk"). Garbage lanes (beyond a chunk's count /
        zero padding) get garbage ranks; `_run_tree` masks mult with the
        live-lane mask."""
        S, _, B = chunk_cols.shape
        # levels sharing one table object (common: the same dimension
        # table joined at every level, configs 3/7) share ONE stats pass
        # over their concatenated key streams — the sort's fixed costs
        # amortize across the group
        groups: dict[int, list[int]] = {}
        for lvl in range(self.n_levels):
            groups.setdefault(id(self.tables[lvl]), []).append(lvl)
        out: list = [None] * self.n_levels
        per = S * B
        for lvls in groups.values():
            flat = chunk_cols[:, lvls, :].transpose(1, 0, 2).reshape(
                len(lvls) * per
            )
            mult, start = sorted_match_ranks(
                self._rank_tables[lvls[0]], flat
            )
            rank = (mult.astype(jnp.int64) << 32) | start.astype(
                jnp.int64
            )
            for i, lvl in enumerate(lvls):
                out[lvl] = rank[i * per : (i + 1) * per].reshape(S, B)
        return jnp.stack(out, axis=1)

    def _run_tree(
        self, level: int, cols, count, pstate, thresholds, valid_extra=None
    ):
        """Probe a dense chunk at `level`, drain its matches, compact,
        and recurse (statically) into deeper levels — the reference's
        ExecutePipeline recursion (main.cpp:119-170) with the per-row
        cursor loop replaced by rank math."""
        cfg = self.config
        block, L = self.block, self.n_levels
        lane = jnp.arange(block, dtype=jnp.int32)
        valid = lane < count
        if valid_extra is not None:
            valid = valid & valid_extra
        keys = cols[level]
        if self.rank_mode == "batched":
            # ranks precomputed per segment and carried as a column;
            # garbage lanes carry garbage ranks — mask mult here (start
            # is only read where mult > drain rank)
            rank = cols[self._rank_col0 + level]
            mult = jnp.where(
                valid, jax.lax.shift_right_logical(rank, 32), 0
            ).astype(jnp.int32)
            start = (rank & jnp.int64(0xFFFFFFFF)).astype(jnp.int32)
        else:
            mult, start = chunk_rank(self.tables[level].keys, keys, valid)

        if (
            level == L - 1
            and self.capacity == 0
            and not cfg.record_occupancy
        ):
            # FINAL-LEVEL COUNT COLLAPSE (trace-time): the collector only
            # reads emitted counts, and sum_t |{mult > t}| == sum(mult),
            # so the whole drain is ONE reduction. Final-level compaction
            # is count-invariant over stream+flush (everything absorbed
            # is re-emitted), so skipping it cannot change the result.
            # Applies under DYNAMIC too — the final level's arm then
            # controls nothing (true on this executor anyway: compaction
            # before a counting collector is dead work), which keeps
            # DYNAMIC's cost surface identical to the statics'; excluded
            # only under record_occupancy (the Zebra histogram would
            # lose its final-level rows).
            total = jnp.sum(mult.astype(jnp.int64))
            return pstate._replace(
                result_count=pstate.result_count + total
            )

        ca = cfg.n_joins + 2 * level
        if self.capacity > 0:
            if cfg.payload_mode is PayloadMode.REFERENCE:
                # (0, matched_key): matched key == probe key at every
                # matching row; col ca keeps its zeros (never written,
                # chaining_ht.cpp:60-80)
                cols = cols.at[ca + 1].set(keys)
            else:
                cols = cols.at[ca].set(keys)
        table = self.tables[level]
        m_entries = max(int(table.keys.shape[0]), 1)

        def drain_step(t, pstate):
            if self.capacity > 0 and cfg.payload_mode is PayloadMode.FULL:
                idx = jnp.clip(start.astype(jnp.int32) + t, 0, m_entries - 1)
                pay = jnp.take(table.payloads, idx)
                cols_t = cols.at[ca + 1].set(pay)
            else:
                cols_t = cols
            # dense-chunk drain: ONE masked scatter compacts the emission
            # to identity-sel layout (core/chunk.compact_rows) instead of
            # a sel composition plus a later gather; every chunk flowing
            # through this executor (emissions, caches, flushes) is
            # dense by construction, so compact/descend/collect all skip
            # their gathers (_dense_chunks)
            dense_t, cnt = compact_rows(cols_t, mult > t)
            chunk = Chunk(dense_t, iota_sel(block), cnt)

            static_thr = None
            if cfg.compact_threshold_per_level is not None:
                static_thr = cfg.compact_threshold_per_level[level]

            def _do_compact(ps):
                cache = comp.CompactorState(
                    cache_cols=ps.cache_cols[level],
                    cache_count=ps.cache_count[level],
                )
                emitted, new_cache = comp.compact(
                    cache, chunk, thresholds[level], chunk_dense=True
                )
                ps = ps._replace(
                    cache_cols=ps.cache_cols.at[level].set(
                        new_cache.cache_cols
                    ),
                    cache_count=ps.cache_count.at[level].set(
                        new_cache.cache_count
                    ),
                )
                if cfg.strategy is CompactionStrategy.DYNAMIC:
                    # one compact execution == one work unit at this
                    # level (its op chain costs about one level-step;
                    # the device tuner's reward reads these counters)
                    ps = ps._replace(
                        level_steps=ps.level_steps.at[level].add(1)
                    )
                return emitted, ps

            if cfg.strategy is CompactionStrategy.NONE or static_thr == 0:
                # threshold 0 == unconditional pass-through
                # (compactor.cpp:6 semantics): skip the compactor ops at
                # TRACE time — per-level static NONE
                emitted = chunk
            elif cfg.branchy_descend:
                # branchy per-chunk compact: compact() computes the
                # absorb path (append_into + cache copies) even for
                # pass-through chunks, which makes compaction a fixed
                # per-step tax under which FULL weakly dominates every
                # threshold. A real
                # branch on compact()'s own pass-through predicate makes
                # pass-throughs free, restoring the reference's actual
                # tradeoff (absorb cost vs small-chunk cascade) that the
                # thresholds — and the DYNAMIC tuner — exist to balance.
                passthrough = (chunk.count >= thresholds[level]) | (
                    chunk.count >= block
                )
                emitted, pstate = jax.lax.cond(
                    passthrough,
                    lambda ps: (chunk, ps),
                    _do_compact,
                    pstate,
                )
            else:
                emitted, pstate = _do_compact(pstate)
            if cfg.record_occupancy:
                pstate = pstate._replace(
                    occupancy=pstate.occupancy.at[level, emitted.count].add(1)
                )
            if level == L - 1:
                return self._collect(pstate, emitted)

            def _descend(ps):
                dense = emitted.cols  # all drain chunks are dense
                if cfg.strategy is CompactionStrategy.DYNAMIC:
                    # work accounting for the device tuner: one entry
                    # into level+1 == one work unit there
                    ps = ps._replace(
                        level_steps=ps.level_steps.at[level + 1].add(1),
                        level_rows=ps.level_rows.at[level + 1].add(
                            emitted.count
                        ),
                    )
                return self._run_tree(
                    level + 1, dense, emitted.count, ps, thresholds
                )

            if not cfg.branchy_descend:
                return _descend(pstate)
            # branchy skip (same A/B flag as the cursor executor): under
            # FULL compaction most drain steps are absorbed into the
            # level cache (emitted.count == 0) — a real branch skips the
            # ENTIRE deeper static subtree (kernels, compaction, collect)
            # instead of running it branch-free on an empty chunk
            return jax.lax.cond(
                emitted.count > 0, _descend, lambda ps: ps, pstate
            )

        F = self._fanout[level]
        if F == 1:
            return drain_step(0, pstate)
        return jax.lax.fori_loop(0, F, drain_step, pstate)

    # ------------------------------------------------------------------
    # jitted entry points (same signatures as JoinPipeline's, so run()
    # and the CLI drive both executors identically)
    # ------------------------------------------------------------------

    def _one_chunk(self, ps, cols, count, thresholds, ranks=None):
        """Push one input chunk through the static level recursion —
        overrides the cursor stepper so the inherited batch scan
        (`_process_chunks`) AND the on-device DYNAMIC tuner
        (`_process_seg_device_dynamic` / `_run_device_dynamic`) drive
        this executor unchanged. `ranks` (int64[n_levels, block],
        batched mode) lands in the chunk's rank columns."""
        W, B = self.width, self.block
        padded = jnp.zeros((W, B), jnp.int64)
        padded = padded.at[: self.config.n_joins, :].set(cols)
        if ranks is not None:
            padded = padded.at[
                self._rank_col0 : self._rank_col0 + self.n_levels, :
            ].set(ranks)
        extra = None
        if self.prefilter is not None:
            extra = self.prefilter(cols[self.prefilter_col])
        if self.config.strategy is CompactionStrategy.DYNAMIC:
            # work counters feed the device tuner's reward only — static
            # strategies skip them (the scan body is op-latency-bound)
            ps = ps._replace(
                level_steps=ps.level_steps.at[0].add(1),
                level_rows=ps.level_rows.at[0].add(count),
            )
        return self._run_tree(0, padded, count, ps, thresholds, extra)

    def _scan_chunks(self, pstate, chunk_cols, chunk_counts, thresholds):
        """lax.scan over one segment's chunks, with the batched rank
        precompute (ONE sort-merge pass per level for the whole segment)
        hoisted ahead of the scan."""
        if self.rank_mode == "batched":
            seg_ranks = self._seg_ranks(chunk_cols)

            def one_chunk(ps, xs):
                cols, count, rk = xs
                return self._one_chunk(ps, cols, count, thresholds, rk), None

            pstate, _ = jax.lax.scan(
                one_chunk, pstate, (chunk_cols, chunk_counts, seg_ranks)
            )
            return pstate

        def one_chunk(ps, xs):
            cols, count = xs  # [n_joins, block], scalar
            return self._one_chunk(ps, cols, count, thresholds), None

        pstate, _ = jax.lax.scan(
            one_chunk, pstate, (chunk_cols, chunk_counts)
        )
        return pstate

    def _process_chunks(self, pstate, chunk_cols, chunk_counts, thresholds):
        return self._scan_chunks(
            pstate, chunk_cols, chunk_counts, thresholds
        )

    def _process_seg_device_dynamic(
        self, pstate, bstate, cols_seg, counts_seg
    ):
        """Device-tuner segment for the SORTED executor. The cursor
        executor's occupancy reward (rows/step at the level) would drive
        every level to FULL — on this executor compaction has a REAL
        per-step cost (the compact op chain + cache copies, skipped by
        the threshold-0 lax.cond), so the reward must be cost-aware:
        stream efficiency = input rows / (block * total work units),
        where work units = level entries + compact executions
        (level_steps, bumped in _run_tree). Shared across levels like
        the reference's one host timer (main.cpp:164-167) — exploration
        is simultaneous, and the UCB estimates marginalize over the
        other levels' mixtures; stays in (0, 1] for the heartbeat
        double/halve detector."""
        from ccve.control import device_bandit as db

        arms_vals = jnp.asarray(
            self.config.resolved_threshold_arms, jnp.int32
        )
        arm, bstate = db.select_arms(
            bstate, self.config.bandit_start_sampling
        )
        thresholds = jnp.take(arms_vals, arm)
        steps0 = pstate.level_steps
        rows_in0 = pstate.level_rows[0]

        pstate = self._scan_chunks(pstate, cols_seg, counts_seg, thresholds)
        d_work = (
            (pstate.level_steps - steps0).astype(jnp.float32).sum()
        )
        d_rows_in = (pstate.level_rows[0] - rows_in0).astype(jnp.float32)
        eff = d_rows_in / (jnp.maximum(d_work, 1.0) * self.block)
        reward = jnp.full((self.n_levels,), eff, jnp.float32)
        bstate = db.update_arms(
            bstate,
            arm,
            reward,
            self.config.bandit_start_sampling,
            self.config.bandit_commit_after,
        )
        return pstate, bstate

    def _flush_all(self, pstate, thresholds):
        """FlushPipelineCache (main.cpp:172-191): level order; refilled
        deeper caches flush in later iterations."""
        for level in range(self.n_levels):
            cache = comp.CompactorState(
                cache_cols=pstate.cache_cols[level],
                cache_count=pstate.cache_count[level],
            )
            flushed, fresh = comp.flush(cache)
            pstate = pstate._replace(
                cache_cols=pstate.cache_cols.at[level].set(fresh.cache_cols),
                cache_count=pstate.cache_count.at[level].set(
                    fresh.cache_count
                ),
            )
            if level + 1 == self.n_levels:
                pstate = self._collect(pstate, flushed)
            else:
                pstate = self._run_tree(
                    level + 1,
                    flushed.cols,
                    flushed.count,
                    pstate,
                    thresholds,
                )
        return pstate
