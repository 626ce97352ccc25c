"""LongProto: long-read-first local assembly (DISCOVAR precursor).

Behavior contract (ref: src/paths/long/LongProto.cc and the src/paths/long/
subtree, SURVEY.md §2.5 "LongProto + src/paths/long/"): assemble a region
from longer reads (250 bp PE or similar) by (1) correcting reads via friend
stacks, (2) building an assembly graph at large K, (3) threading the
corrected reads through it as ReadPaths, and (4) simplifying the graph using
that path support (low-support deletion, pull-aparts), emitting a final
SupportedHyperBasevector-equivalent and contigs.

Device shape: friend finding + kmer counting + unipath condensation +
read pathing are device sort/join programs; the support-driven cleanup runs
on the condensed (small) graph host-side — same split as the rest of the
framework (SURVEY.md §7.1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import jax.numpy as jnp

from allpathslg_tpu.graph import unipath as gup
from allpathslg_tpu.graph import pathsdb as pdb
from allpathslg_tpu.graph import cleanup
from allpathslg_tpu.kmer import count as kcount
from allpathslg_tpu.long import friends as fr
from allpathslg_tpu.long import supported as sup


@dataclasses.dataclass(frozen=True)
class LongProtoConfig:
    K: int = 48                 # large-K graph (the reference uses K=200-ish
                                # on 250bp reads; scaled to read length)
    friend_k: int = 16
    min_shared: int = 3
    correction_rounds: int = 1
    min_kmer_count: int = 2
    min_support: int = 2
    min_thread_support: int = 2
    ploidy: int = 1


@dataclasses.dataclass
class LongProtoResult:
    contigs: cleanup.Contigs
    sg: sup.SupportedGraph
    metrics: Dict[str, int]


def long_proto(codes: np.ndarray, cfg: LongProtoConfig = LongProtoConfig()
               ) -> LongProtoResult:
    """Assemble a read batch the LongProto way. codes: uint8 [N, L]."""
    metrics: Dict[str, int] = {}

    # 1) friend-stack correction
    corrected = codes
    total_fixed = 0
    n_friend_records = 0
    for _ in range(cfg.correction_rounds):
        f = fr.find_friends(corrected, K=cfg.friend_k,
                            min_shared=cfg.min_shared)
        n_friend_records = int(len(f.a))
        corrected, n_fixed = fr.correct_with_friends(corrected, f)
        total_fixed += n_fixed
        if n_fixed == 0:
            break
    metrics["n_bases_corrected"] = total_fixed
    metrics["n_friend_records"] = n_friend_records

    # 2) large-K graph from corrected reads
    ck = kcount.count_reads_streaming(corrected, cfg.K)
    ck = kcount.trim_to_host(ck)
    built = gup.build_unipaths([jnp.asarray(w) for w in ck.words], cfg.K,
                               min_count=cfg.min_kmer_count,
                               counts=np.asarray(ck.counts),
                               with_graph=True, with_placement=True)
    ups, g, placement = built
    metrics["n_unipaths"] = ups.n

    # 3) thread corrected reads through the graph (ReadPaths)
    rp = pdb.path_reads(placement, corrected)

    # 4) support-driven simplification (iterated, with path revision after
    # every edit — the reference's LongProto loop)
    sg = sup.build_supported(ups, g, rp)
    sg, m, rp = sup.simplify_supported(sg, rp, cfg.min_support,
                                       cfg.min_thread_support,
                                       ploidy=cfg.ploidy, K=cfg.K)
    metrics.update(m)

    # the pulled-apart graph changed node ids → re-derive support for merge
    contigs, cm = cleanup.simplify(sg.ups, sg.g, cfg.K, ploidy=cfg.ploidy)
    metrics.update({f"cleanup_{k}": v for k, v in cm.items()})
    return LongProtoResult(contigs=contigs, sg=sg, metrics=metrics)
