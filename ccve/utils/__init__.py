"""Utilities: profiling (reference L0 profiler suite)."""

from ccve.utils.profiler import (
    BeeProfiler,
    PhaseProfiler,
    Timer,
    ZebraProfiler,
)

__all__ = ["BeeProfiler", "ZebraProfiler", "PhaseProfiler", "Timer"]
