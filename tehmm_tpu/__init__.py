"""tehmm_tpu — multi-track HMM genome-annotation engine for accelerators.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the reference
``glennhickey/teHmm`` toolkit (see SURVEY.md): multi-track hidden Markov
models with independent categorical emissions over discretized genomic
tracks, log-space forward/backward/Viterbi DP as ``lax.scan`` /
``associative_scan`` kernels, Baum-Welch EM (supervised / semi-supervised /
unsupervised), genome chunk sharding over a device mesh, and
reference-compatible BED/XML I/O.

Layer map (SURVEY.md §7):
  - ``models``    — parameter pytrees, emission model, HMM/CFG model API
  - ``ops``       — the DP compute kernels (scan, associative-scan, and
                    GPU kernels in Pallas)
  - ``parallel``  — mesh construction, chunking, halo stitching, sharded EM
  - ``io``        — host-side genomic I/O (tracks XML, BED, FASTA, BigWig)
  - ``cli``       — reference-compatible command line tools
  - ``utils``     — logging, constants, small helpers
"""

__version__ = "0.2.0"
