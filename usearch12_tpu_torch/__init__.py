"""usearch12_tpu_torch — the usearch12_tpu search engine on PyTorch and
CUDA for NVIDIA Hopper cards.

A port beside the JAX package usearch12_tpu, which stays the reference.
The port keeps its own copy of the host layers (option registry, FASTA
and UDB I/O, the C runtime for parsing, ranking, HSP chaining and
accept/terminate replay in native/, clustering, the amplicon and FASTQ
commands, the output writers) and replaces the device layer: the hole
alignments of usearch_global and the bootstraps of sintax run in CUDA
kernels written for sm_90a (csrc/), built at first use by _build.py.
Nothing in this package imports jax or usearch12_tpu.
"""

__version__ = "0.1.0"
