"""usearch12_tpu_torch — the usearch12_tpu search engine on PyTorch and
CUDA for NVIDIA Hopper cards.

A port beside the JAX package usearch12_tpu, which stays the reference.
The port reuses the JAX package's host layers unchanged (option
registry, FASTA and UDB I/O, the C runtime for parsing, ranking, HSP
chaining and accept/terminate replay, the output writers, and every
command without device code) and replaces its device layer: the hole
alignments of usearch_global and the bootstraps of sintax run in CUDA
kernels written for sm_90a (csrc/), built at first use by _build.py.
Nothing in this package imports jax.
"""

__version__ = "0.1.0"
