"""allpathslg_tpu — a JAX short-read de novo assembler.

A from-scratch JAX/XLA re-architecture of the capabilities of
ALLPATHS-LG (genome-vendor/allpathslg, Broad Institute): quality-aware k-mer
error correction, fragment-pair filling, a K=96 unipath-graph assembly
substrate, localized assembly and merging, jump-library scaffolding with
probabilistic gap remodeling, and EFASTA/AGP/report outputs.

This is NOT a port: every hot path (k-mer counting, error correction, banded
DP alignment, unipath condensation, link accumulation) is a batched device
kernel built on three primitives — multi-word lexicographic sort, segmented
reduce/scan, and searchsorted join — with hash-sharded all_to_all
redistribution across a `jax.sharding.Mesh` for multi-chip scale.

Layer map (mirrors reference layers in SURVEY.md §1):
  dtypes/    packed 2-bit base tensors, ragged batches     (ref: src/feudal/)
  io/        FASTQ/FASTA/EFASTA/AGP + chunked array store  (ref: src/util/, src/efasta/)
  ops/       device kernel bedrock: sort, segmented ops,
             searchsorted join, batched banded DP          (ref: src/ParallelVecUtilities.h,
                                                            src/pairwise_aligners/)
  kmer/      bit-packed kmer math, counting, spectra       (ref: src/kmers/)
  ec/        read error correction family                  (ref: src/paths/FindErrors.cc)
  graph/     kmer numbering, unipath graph, cleanup        (ref: src/paths/Unipath.cc, HyperBasevector)
  asm/       fragment filling, localization, merging       (ref: src/paths/FillFragments.cc, LocalizeReadsLG.cc)
  align/     lookup aligner, alignlets                     (ref: src/lookup/)
  scaffold/  link graph, scaffolds, gap remodel            (ref: src/paths/MakeScaffolds.cc, RemodelGaps.cc)
  parallel/  mesh, sharded spectrum, collectives           (ref: none — reference is single-host)
  pipeline/  stage DAG runner, manifests, CLI, report      (ref: RunAllPathsLG Perl driver)
  eval/      simulators, N50/stats, accuracy oracles       (ref: src/paths/AssemblyAccuracy.cc)
"""

__version__ = "0.1.0"
