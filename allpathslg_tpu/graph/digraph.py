"""Edge-table directed graphs with device-side component labeling.

Behavior contract (ref: src/graph/Digraph.{h,cc} `digraph`/`digraphE<E>` —
SURVEY.md §2.1): the substrate of unipath graphs, link graphs and scaffolds.
Device form: edges as (src, dst, payload-index) arrays; connected
components via iterated min-label propagation (pointer jumping) in jnp;
small-graph conveniences on host.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax


@dataclasses.dataclass
class EdgeGraph:
    """digraphE analog: n vertices, parallel edge arrays + payload index."""
    n: int
    src: np.ndarray    # int32 [E]
    dst: np.ndarray    # int32 [E]

    @property
    def n_edges(self) -> int:
        return len(self.src)

    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n)

    def delete_edges(self, mask: np.ndarray) -> "EdgeGraph":
        keep = ~np.asarray(mask)
        return EdgeGraph(self.n, self.src[keep], self.dst[keep])


@jax.jit
def _components_device(src, dst, labels):
    n_iter = max(1, int(np.ceil(np.log2(max(labels.shape[0], 2)))) + 1)

    def body(_, lab):
        # edge relaxation: both endpoints take the min label
        m = jnp.minimum(lab[src], lab[dst])
        lab = lab.at[src].min(m)
        lab = lab.at[dst].min(m)
        # pointer jumping through the label array
        return lab[lab]

    return lax.fori_loop(0, 2 * n_iter, body, labels)


def connected_components(g: EdgeGraph) -> np.ndarray:
    """Weakly connected component label (min vertex id) per vertex."""
    if g.n == 0:
        return np.zeros(0, np.int32)
    labels = jnp.arange(g.n, dtype=jnp.int32)
    if g.n_edges == 0:
        return np.asarray(labels)
    out = _components_device(jnp.asarray(g.src), jnp.asarray(g.dst), labels)
    return np.asarray(out)


def components_as_lists(g: EdgeGraph) -> List[np.ndarray]:
    lab = connected_components(g)
    order = np.argsort(lab, kind="stable")
    labs = lab[order]
    cuts = np.nonzero(np.diff(labs))[0] + 1
    return np.split(order, cuts)
