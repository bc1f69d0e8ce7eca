"""smalt_tpu — a DNA read-alignment engine on an accelerator.

A from-scratch re-design of the SMALT hashing read aligner
(reference: rcallahan/smalt v0.7.6) for accelerator hardware: the
sampled k-mer index lives as flat device arrays, seed lookup and
candidate collation are vectorized JAX gather/sort programs, and the
Smith-Waterman scoring runs as batched JAX scans. Host-side
Python/NumPy/C handles the irregular tails (FASTQ IO, traceback walk,
SAM text).

Layer map (≈ reference layers, see SURVEY.md):
  seq/      sequence codec + FASTA/FASTQ IO + reference set   (sequence.c)
  index/    sampled k-mer index build + lookup                (hashidx.c)
  seed/     per-read k-mer hit collection                     (hashhit.c)
  segment/  seeds -> constant-shift segments -> candidates    (segment.c)
  align/    banded affine SW kernels + diff strings           (alignment.c, swsimd.c, diffstr.c)
  results/  result sets, mapq, pairing, insert sizes          (results.c, resultpairs.c, insert.c)
  report/   SAM/CIGAR/SSAHA/GFF2 output                       (report.c)
  map/      per-read mapping engine + batch pipeline          (rmap.c, smalt.c)
  ops/      batched device Smith-Waterman scorers             (swsimd.c)
  parallel/ device mesh, sharded index, collectives           (threads.c analogue)
"""

__version__ = "0.1.0"
