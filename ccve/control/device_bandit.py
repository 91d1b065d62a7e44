"""On-DEVICE UCB1-tuned bandit — the dynamic-compaction tuner.

The reference's CompactTuner runs on the host between pipeline calls
(negative_feedback.hpp:165-260), timing each level's segment with host
clocks (main.cpp:143-167) — free in its synchronous single-thread world.
Beside an accelerator, a host-side bandit costs one host sync per
segment, and a single-dispatch executor cannot attribute one wall time
across levels at all.

This module keeps the reference's exact bandit math (UCB1-tuned variance
bonus, warm-start round-robin, EW factor capped at 15, heartbeat change
detection — control/bandit.py documents the citations) but vectorizes it
over levels in jnp so the whole select → run segment → update loop lives
INSIDE one device dispatch:

 - reward: the executor counts work-loop steps PER LEVEL (each step is a
   fixed-shape op chain, so steps ∝ device time — the quantity the
   reference's timer measured, minus the noise). Per-level step deltas
   give TRUE per-level credit, which the host timer never had.
 - zero host round trips: thresholds are lax-selected between segments
   from the carried bandit state.

Two convergence-cost reducers on top of the reference math (DYNAMIC's
only possible win on this executor is fast zero-knowledge convergence —
FULL weakly dominates structurally, bench/configs.config6 — so the
warm-start/exploration floor IS the regret):

 - configurable warm start (`start_sampling`, default 2 vs the
   reference's kStartSampling=4, negative_feedback.hpp:37-45): the
   occupancy reward is far less noisy than the reference's wall-clock
   reward, so half the round-robin rounds suffice;
 - EARLY COMMIT: once warm start is done and the greedy arm has stayed
   the same for `commit_after` consecutive updates, the level commits —
   selection becomes pure exploit, no UCB bonus can drag it back to a
   dominated arm. The heartbeat change detector still fires on the
   committed arm's own reward (double/halve), which UNCOMMITS and
   re-warm-starts — the reference's non-stationarity semantics
   (negative_feedback.hpp:67-81) are preserved.

State is a flat pytree of [n_levels, n_arms] arrays; all ops are
branch-free selects, so one compiled program serves every trajectory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

EPSILON = 0.1
START_SAMPLING = 2  # default; the reference's value is 4
COMMIT_AFTER = 8
HEARTBEAT = 256
EW_CAP = 15


class DeviceBanditState(NamedTuple):
    est: jax.Array  # f32[L, A] estimated rewards
    est_sq: jax.Array  # f32[L, A]
    n_upd: jax.Array  # i32[L, A] stage update counts per arm
    t_upd: jax.Array  # i32[L] stage update totals
    n_sel: jax.Array  # i32[L, A] lifetime selects per arm
    sel_times: jax.Array  # i32[L]
    n_start: jax.Array  # i32[L] warm-start progress
    r_means: jax.Array  # f32[L, A] last-heartbeat estimates
    hb_seen: jax.Array  # i32[L] heartbeat snapshot taken yet
    committed: jax.Array  # i32[L] committed arm, -1 = still exploring
    streak: jax.Array  # i32[L] consecutive updates with same greedy arm
    last_greedy: jax.Array  # i32[L]
    commit_t: jax.Array  # i32[L] sel_times at commit (-1 = never) — the
    #   "commit round" for the bandit history readback


def init_state(n_levels: int, n_arms: int) -> DeviceBanditState:
    return DeviceBanditState(
        est=jnp.zeros((n_levels, n_arms), jnp.float32),
        est_sq=jnp.zeros((n_levels, n_arms), jnp.float32),
        n_upd=jnp.zeros((n_levels, n_arms), jnp.int32),
        t_upd=jnp.zeros((n_levels,), jnp.int32),
        n_sel=jnp.zeros((n_levels, n_arms), jnp.int32),
        sel_times=jnp.zeros((n_levels,), jnp.int32),
        n_start=jnp.zeros((n_levels,), jnp.int32),
        r_means=jnp.zeros((n_levels, n_arms), jnp.float32),
        hb_seen=jnp.zeros((n_levels,), jnp.int32),
        committed=jnp.full((n_levels,), -1, jnp.int32),
        streak=jnp.zeros((n_levels,), jnp.int32),
        last_greedy=jnp.full((n_levels,), -1, jnp.int32),
        commit_t=jnp.full((n_levels,), -1, jnp.int32),
    )


def select_arms(
    st: DeviceBanditState, start_sampling: int = START_SAMPLING
) -> tuple[jax.Array, DeviceBanditState]:
    """Per-level arm indices i32[L] (committed arm if any, else
    warm-start round-robin, then UCB1-tuned argmax —
    negative_feedback.hpp:34-61)."""
    L, A = st.est.shape
    warm = st.n_start < A * start_sampling
    arm_warm = st.n_start % A

    t = st.t_upd.astype(jnp.float32)[:, None]
    n = st.n_upd.astype(jnp.float32) + EPSILON
    log_t = jnp.where(t > 0, jnp.log(jnp.maximum(t, 1.0)), -jnp.inf)
    var = st.est_sq - st.est * st.est + jnp.sqrt(
        jnp.maximum(2.0 * log_t / n, 0.0)
    )
    inner = log_t / n * jnp.minimum(0.25, var)
    bonus = jnp.where(
        jnp.isfinite(inner) & (inner >= 0), jnp.sqrt(jnp.abs(inner)), 0.0
    )
    arm_ucb = jnp.argmax(st.est + bonus, axis=1).astype(jnp.int32)

    arm = jnp.where(warm, arm_warm, arm_ucb)
    arm = jnp.where(st.committed >= 0, st.committed, arm)
    onehot = jax.nn.one_hot(arm, A, dtype=jnp.int32)
    return arm, st._replace(
        n_start=st.n_start + (warm & (st.committed < 0)).astype(jnp.int32),
        sel_times=st.sel_times + 1,
        n_sel=st.n_sel + onehot,
    )


def update_arms(
    st: DeviceBanditState,
    arm: jax.Array,
    reward: jax.Array,
    start_sampling: int = START_SAMPLING,
    commit_after: int = COMMIT_AFTER,
) -> DeviceBanditState:
    """EW update + heartbeat change detection for each level's chosen
    arm (negative_feedback.hpp:67-97), plus the early-commit tracker.
    `commit_after <= 0` disables committing (pure reference behavior)."""
    L, A = st.est.shape
    onehot = jax.nn.one_hot(arm, A, dtype=jnp.float32)

    # --- heartbeat (before the update, like the reference) ------------
    at_hb = (st.sel_times % HEARTBEAT == 0) & (
        st.n_start >= A * start_sampling
    )
    cur = jnp.take_along_axis(st.est, arm[:, None], axis=1)[:, 0]
    ref = jnp.take_along_axis(st.r_means, arm[:, None], axis=1)[:, 0]
    detected = at_hb & (st.hb_seen > 0) & ((cur > ref * 2) | (cur < ref / 2))
    r_means = jnp.where(at_hb[:, None], st.est, st.r_means)
    hb_seen = jnp.where(at_hb, 1, st.hb_seen)

    reset = detected[:, None]
    est = jnp.where(reset, 0.0, st.est)
    est_sq = jnp.where(reset, 0.0, st.est_sq)
    n_upd = jnp.where(reset, 0, st.n_upd)
    t_upd = jnp.where(detected, 0, st.t_upd)
    n_start = jnp.where(detected, 0, st.n_start)

    # --- EW update of the chosen arm -----------------------------------
    factor = jnp.minimum(
        jnp.take_along_axis(n_upd, arm[:, None], axis=1)[:, 0], EW_CAP
    ).astype(jnp.float32)
    ratio = factor / (factor + 1.0)
    new_est_arm = (
        jnp.take_along_axis(est, arm[:, None], axis=1)[:, 0] * ratio
        + reward * (1 - ratio)
    )
    new_sq_arm = (
        jnp.take_along_axis(est_sq, arm[:, None], axis=1)[:, 0] * ratio
        + reward * reward * (1 - ratio)
    )
    est = est * (1 - onehot) + onehot * new_est_arm[:, None]
    est_sq = est_sq * (1 - onehot) + onehot * new_sq_arm[:, None]
    onehot_i = onehot.astype(jnp.int32)

    # --- early commit ---------------------------------------------------
    # a change-detection reset uncommits and restarts the streak; while
    # committed the streak math is frozen (greedy == committed trivially)
    greedy = jnp.argmax(est, axis=1).astype(jnp.int32)
    warm_done = n_start >= A * start_sampling
    # the streak accrues only over genuine greedy selections: during the
    # warm-start round-robin `greedy` is an argmax of partially-populated
    # estimates, and letting it count toward the commit streak allowed a
    # commit on the very first post-warm update (each arm sampled just
    # start_sampling times) with no recovery before the HEARTBEAT
    streak = jnp.where(
        warm_done, jnp.where(greedy == st.last_greedy, st.streak + 1, 1), 0
    )
    commit_now = (
        (commit_after > 0)
        & warm_done
        & (st.committed < 0)
        & (streak >= commit_after)
        & ~detected
    )
    committed = jnp.where(detected, -1, st.committed)
    committed = jnp.where(commit_now, greedy, committed)
    commit_t = jnp.where(commit_now, st.sel_times, st.commit_t)
    streak = jnp.where(detected, 0, streak)
    last_greedy = jnp.where(detected, -1, greedy)

    return DeviceBanditState(
        est=est,
        est_sq=est_sq,
        n_upd=n_upd + onehot_i,
        t_upd=t_upd + 1,
        n_sel=st.n_sel,
        sel_times=st.sel_times,
        n_start=n_start,
        r_means=r_means,
        hb_seen=hb_seen,
        committed=committed,
        streak=streak,
        last_greedy=last_greedy,
        commit_t=commit_t,
    )
