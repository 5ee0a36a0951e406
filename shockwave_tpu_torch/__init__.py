"""PyTorch and CUDA port of shockwave_tpu, grown slice by slice.

The JAX package ``shockwave_tpu`` stays the reference; this package
imports none of it (nor JAX) and keeps its own copy of what it needs.
See ROADMAP.md for what is ported and what comes next.
"""
