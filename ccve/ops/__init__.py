"""L3 operators: hash primitives, hash tables, sort-merge join, compactor,
filter, aggregate, radix sort (reference L0/L3; SURVEY.md §2)."""

from ccve.ops.hashing import murmurhash64, murmurhash64_np, murmurhash64_py

__all__ = [
    "murmurhash64",
    "murmurhash64_np",
    "murmurhash64_py",
]
