"""Adaptive control — the bandit-tuned compaction-threshold learner
(reference L2, negative_feedback.hpp)."""

from ccve.control.bandit import MultiArmedBandit, CompactTuner

__all__ = ["MultiArmedBandit", "CompactTuner"]
