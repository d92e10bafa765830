"""mercat2_tpu: a GPU-accelerated k-mer counting and diversity-estimation framework.

A from-scratch rebuild of the capabilities of raw-lab/mercat2 (the reference
CPU/Ray pipeline) on JAX:

- sequences are packed host-side into b-bit symbol codes,
- k-mer extraction + counting runs on-device as a fused multiword rolling
  pack -> lexicographic sort -> run-length-encode pipeline (XLA),
- multi-device scaling uses ``jax.sharding.Mesh`` + ``shard_map`` with
  ``psum``/all-to-all merges,
- all downstream analytics (diversity, protein metrics, PCA, HTML report)
  are implemented natively (no skbio/plotly/dominate dependencies).

Reference parity: per-sample count TSVs are byte-identical to MerCat2's
(``/root/reference/bin/mercat2.py:115-137``) on the bundled test data.
"""

from mercat2_tpu.version import __version__

__all__ = ["__version__"]
