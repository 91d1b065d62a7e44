"""ccve — a vectorized query-execution engine with chunk compaction.

A from-scratch JAX/XLA re-design of the capabilities of the reference
C++/AVX-512 codebase `Chunk-Compaction-in-Vectorized-Execution-SIMD`
(see SURVEY.md): vectorized hash joins over linear-probing and chaining
hash tables, a gather-free sort-merge join, chunk compaction of
under-filled selection vectors (full / binary / dynamic bandit-tuned
strategies), an N-way join pipeline executor, plus filter, hash
aggregate, radix sort, and a distributed multi-device tier over a
`jax.sharding.Mesh`.

The engine operates on int64 columns and requires 64-bit mode; importing this
package enables `jax_enable_x64`.
"""

import os

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX itself reads JAX_COMPILATION_CACHE_DIR
# when it is set; otherwise compiled programs go to one fixed directory
# inside the checkout (git-ignored), so every process of this checkout
# finds what an earlier one compiled.
CACHE_DIR = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from ccve.config import EngineConfig, CompactionStrategy  # noqa: E402

__all__ = ["EngineConfig", "CompactionStrategy"]
__version__ = "0.1.0"
