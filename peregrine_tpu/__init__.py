"""peregrine_tpu — an accelerator OLC genome assembler for accurate long reads.

A from-scratch re-design of the Peregrine assembler (SHIMMER hierarchical
minimizer index + overlap + string-graph layout + FALCON-style consensus):
the compute path is JAX/XLA array programs over sharded device arrays; the
host runtime (I/O, graph layout, stage orchestration) is Python + native
C++ extensions.

Reference capability map: see SURVEY.md at the repo root.  File-format
compatibility targets the reference's on-disk ABI (SURVEY.md §2.4) so that
outputs can be validated against the reference pipeline.
"""

import os as _os

import jax

# 56-bit minimizer hashes and packed (hash, rid, pos, strand) records need
# 64-bit integer lanes; enable x64 once, package-wide, before any tracing.
jax.config.update("jax_enable_x64", True)

# Persistent-compile-cache keys must not depend on WHO calls a kernel:
# lowered modules embed the full caller traceback in their locations by
# default, so the same jit invoked from a different script — or after any
# line-number shift in a caller — gets a fresh cache key and a full
# recompile.  Stripping tracebacks from locations makes the lowering
# byte-identical across call paths.
jax.config.update("jax_include_full_tracebacks_in_locations", False)

# Persistent compile cache: JAX reads JAX_COMPILATION_CACHE_DIR itself when
# it is set; otherwise the cache lives at a fixed path in the checkout (the
# path is part of the cache key, so it must not move between runs).
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"))

__version__ = "0.1.0"
