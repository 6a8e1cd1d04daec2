"""exonerate_tpu — an accelerated generic pairwise sequence-comparison framework.

A from-scratch reimplementation of the capabilities of exonerate
(G. Slater & E. Birney) in JAX, run on a GPU: alignment models are
declarative weighted finite-state automata (a model IR mirroring the
reference C4 DSL, ref: src/c4/c4.h:61-194) from which generic engines are
derived:

- a NumPy reference interpreter (the correctness oracle, the analogue of
  Viterbi_interpreted, ref: src/c4/viterbi.c:655-837),
- a JAX anti-diagonal wavefront engine (jit/vmap; the analogue of the
  reference's generated-C DP kernels, ref: src/c4/viterbi.c:869-1758),
- native C++ engines for the host side (dense Viterbi, the SDP
  scheduler, seeding),
- seeded heuristics (word seeding + HSP extension + banded gapped extension,
  the analogue of seeder/hspset/sdp), whose band scans run on the device
  (engine/sdp_device.py).

Which engine runs where is decided in one place, exonerate_tpu/device.py.

Scores are int32 everywhere; outputs aim for byte parity with the reference.
"""

__version__ = "0.1.0"

IMPOSSIBLY_LOW_SCORE = -987654321   # ref: src/c4/c4.h:29
IMPOSSIBLY_HIGH_SCORE = 987654321   # ref: src/c4/c4.h:30


def compilation_cache_dir() -> str:
    """Where compiled programs persist: JAX_COMPILATION_CACHE_DIR when
    set, else a fixed directory in the checkout (the path is part of
    the cache's key, so it must not move between runs)."""
    import os
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".jax_cache")


def enable_compilation_cache() -> str:
    """Point JAX at the persistent compilation cache so compiles survive
    across processes — the runtime analogue of the reference
    bootstrapper's compiled-model archive (ref:
    src/model/bootstrapper.c:412-428).  Called by every entry point
    that uses JAX; returns the directory."""
    import jax
    cache = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", cache)
    # locus workloads generate many ~2-5 s traces (bucket shapes x
    # batch sizes x masked variants); a 5 s floor excluded nearly all
    # of them from the cache, recompiling every run
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    return cache
