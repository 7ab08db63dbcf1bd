"""vcfc_tpu — an accelerator-native VCF genotype compression engine.

A from-scratch re-design of the capabilities of theferrit32/vcf-compression
("VCFC") for a JAX accelerator (an NVIDIA H100): VCF data lines are parsed
host-side into dense sample-by-variant genotype code matrices, run-length
encoded on device with vectorized XLA scans, and emitted byte-for-byte
compatible with the reference ``.vcfc`` format.  Random access is provided
by the reference's binned index (``.vcfci``), sparse external index, and
offset-as-index sparse files, plus a columnar block manifest.

Layout (see SURVEY.md §7):
  format/    the byte contract: length headers, RLE flag bytes, line codec
  host/      VCF text parsing <-> dense device arrays (numpy + native C++)
  ops/       device codec kernels (jnp vectorized scans), Huffman coding
  parallel/  device meshes, sharded encode, collective merges
  index/     binned / sparse-external / offset-as-index random access
  query/     coordinate model and query engines
  eval/      benchmark harness (reference-compatible TIMING taxonomy)
  utils/     configs, reference-name ordinals, timing probes
"""

__version__ = "0.3.0"

import os as _os


def _configure_compile_cache() -> None:
    """Persist compiled executables across processes.  A user-set
    ``JAX_COMPILATION_CACHE_DIR`` wins untouched (JAX reads it itself);
    otherwise the cache sits at a FIXED path inside the checkout — the
    path is part of the cache key, so it must not move between runs."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    checkout = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    jax.config.update(
        "jax_compilation_cache_dir", _os.path.join(checkout, ".jax_cache")
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)


_configure_compile_cache()
