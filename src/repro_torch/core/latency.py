"""Token communication + computation latency models (paper Sec. II-C, Eq. 16).

Per-hop latency  T_hat = T_pr + T_tx              (Eq. 4-6)
Multi-hop        D_{u,v}(n) = Dijkstra shortest path over G(n)   (Eq. 7)
Computation      T_cmp = W_cmp / f                (Eq. 16)

The per-slot topology realizations are packed into a ``TopologySample``
(edge masks + per-edge latencies) from which distance rows are computed
lazily with scipy's Dijkstra.

A copy of ``repro.core.latency`` (host numpy), held bitwise to it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import dijkstra

from .constellation import SPEED_OF_LIGHT, Constellation

UNREACHABLE = np.inf


@dataclasses.dataclass(frozen=True)
class LinkConfig:
    """Token transmission parameters (Eq. 6)."""

    token_dim: int = 4096          # M, token-embedding dimension
    bits_per_value: int = 16       # Q_B quantization
    isl_rate_gbps: float = 100.0   # R_{u,v}

    @property
    def tx_latency_s(self) -> float:
        return (self.token_dim * self.bits_per_value) / (self.isl_rate_gbps * 1e9)


@dataclasses.dataclass(frozen=True)
class ComputeConfig:
    """Satellite onboard compute (paper Sec. VII-A: Frontgrade SBC-2A72)."""

    peak_gflops: float = 10.4
    utilization: float = 0.7

    @property
    def flops_per_s(self) -> float:
        return self.peak_gflops * 1e9 * self.utilization  # 7.28 GFLOPS default

    def latency_s(self, work_flops: float) -> float:
        """T_cmp = W_cmp / f  (Eq. 16)."""
        return work_flops / self.flops_per_s


@dataclasses.dataclass
class TopologySample:
    """A realization of the time-varying graph sequence {G(n)}.

    Attributes
    ----------
    edges:        (E, 2) static candidate edge list.
    edge_mask:    (N_T, E) bool — E_{u,v}(n) per slot.
    edge_latency: (N_T, E) float seconds — per-hop T_hat (Eq. 4) per slot.
    n_sats:       number of graph nodes.
    """

    edges: np.ndarray
    edge_mask: np.ndarray
    edge_latency: np.ndarray
    n_sats: int

    @property
    def n_slots(self) -> int:
        return self.edge_mask.shape[0]

    def availability(self) -> float:
        """Fraction of (slot, edge) pairs that are up."""
        return float(self.edge_mask.mean())

    def graph(self, slot: int) -> sp.csr_matrix:
        """Symmetric weighted adjacency for slot n (weights = latency)."""
        m = self.edge_mask[slot]
        e = self.edges[m]
        w = self.edge_latency[slot][m]
        g = sp.coo_matrix(
            (np.concatenate([w, w]),
             (np.concatenate([e[:, 0], e[:, 1]]),
              np.concatenate([e[:, 1], e[:, 0]]))),
            shape=(self.n_sats, self.n_sats),
        )
        return g.tocsr()

    def distances_from(self, slot: int, sources: np.ndarray,
                       node_mask: np.ndarray | None = None) -> np.ndarray:
        """Shortest-path latency rows D_{src, .}(n) (Eq. 7), shape (S, V).

        ``node_mask`` (V,) bool restricts routing to a node subset (used to
        emulate intra-subnet-only routing; see EXPERIMENTS.md §Fidelity).
        """
        g = self.graph(slot)
        if node_mask is not None:
            keep = np.asarray(node_mask)
            diag = sp.diags(keep.astype(np.float64))
            g = (diag @ g @ diag).tocsr()
            g.eliminate_zeros()
        return dijkstra(g, directed=False, indices=np.asarray(sources))


def sample_topology(
    constellation: Constellation,
    link: LinkConfig,
    rng: np.random.Generator,
    slots: np.ndarray | None = None,
) -> TopologySample:
    """Draw one realization of {G(n)}_{n=1..N_T} with per-edge latencies."""
    cfg = constellation.cfg
    times = constellation.cfg.slot_times() if slots is None else slots
    n_slots = len(times)
    edges = constellation.edges
    masks = np.zeros((n_slots, edges.shape[0]), dtype=bool)
    lats = np.zeros((n_slots, edges.shape[0]), dtype=np.float64)
    for n, t in enumerate(times):
        masks[n] = constellation.sample_edge_mask(float(t), rng)
        # T_pr (Eq. 5) + T_tx (Eq. 6)
        lats[n] = constellation.edge_distances(float(t)) / SPEED_OF_LIGHT + link.tx_latency_s
    return TopologySample(edges=edges, edge_mask=masks, edge_latency=lats, n_sats=cfg.n_sats)


def node_masks_from_sets(node_sets: list, n_sats: int) -> list[np.ndarray]:
    """Per-layer node-index lists -> (V,) bool routing masks."""
    masks = []
    for nodes in node_sets:
        m = np.zeros(n_sats, dtype=bool)
        m[np.asarray(nodes)] = True
        masks.append(m)
    return masks


def source_distance_table(
    topo: TopologySample,
    sources: np.ndarray,
    node_masks: list | None = None,
) -> np.ndarray:
    """D[n, s, v]: shortest-path latency from arbitrary source nodes.

    Shape (N_T, S, V).  This is the host-side precompute feeding the
    batched plan-evaluation engine (:mod:`repro_torch.core.engine`): the engine
    dedupes gateway nodes across a whole plan sweep into one ``sources``
    vector, so Dijkstra runs once per (slot, unique gateway) instead of
    once per (slot, plan, layer).

    ``node_masks`` (optional, one (V,) bool mask or None per source)
    restricts routing per source row; sources sharing a mask are batched
    into a single Dijkstra call per slot.
    """
    sources = np.asarray(sources)
    out = np.empty((topo.n_slots, len(sources), topo.n_sats), dtype=np.float64)
    if node_masks is None:
        for n in range(topo.n_slots):
            out[n] = topo.distances_from(n, sources)
        return out
    # Group source rows by identical mask so each (slot, mask) pair costs
    # one batched Dijkstra.
    groups: dict[bytes, list[int]] = {}
    for si, mask in enumerate(node_masks):
        key = b"" if mask is None else np.asarray(mask, dtype=bool).tobytes()
        groups.setdefault(key, []).append(si)
    for rows in groups.values():
        mask = node_masks[rows[0]]
        for n in range(topo.n_slots):
            out[n, rows] = topo.distances_from(n, sources[rows], mask)
    return out


def gateway_distance_table(
    topo: TopologySample, gateways: np.ndarray,
    node_sets: list | None = None,
) -> np.ndarray:
    """D[n, g, v]: shortest-path latency from each gateway to every node.

    Shape (N_T, L, V).  Unreachable pairs are +inf (handled downstream with
    masked means).  The graph is undirected so D(g, v) = D(v, g) and this
    single table serves both the dispatch (gateway->expert) and combine
    (expert->next gateway) hops of Eq. 22.

    ``node_sets`` (one node-index array per layer) restricts layer l's
    routing to those nodes — the paper-style intra-subnet-only mode.
    """
    gateways = np.asarray(gateways)
    if node_sets is None:
        return source_distance_table(topo, gateways)
    masks = node_masks_from_sets(node_sets, topo.n_sats)
    return source_distance_table(topo, gateways, masks)


def expected_path_latency(
    dist_table: np.ndarray,
    layer: int,
    n_layers: int,
    compute_latency_s: np.ndarray | float = 0.0,
) -> np.ndarray:
    """tau_bar_s per candidate satellite for one layer (Eq. 21 + Eq. 27).

    tau_s^(n) = T_cmp + D(phi_l, s; n) + D(s, phi_{l+1}; n), with the ring
    wrap-around for the last layer (Eq. 22); expectation over slots uses a
    masked mean so slots in which s is unreachable do not poison the
    average (rare at survival=0.95).  Satellites unreachable in *every*
    slot get +inf.
    """
    nxt = (layer + 1) % n_layers
    path = dist_table[:, layer, :] + dist_table[:, nxt, :]      # (N_T, V)
    finite = np.isfinite(path)
    cnt = finite.sum(axis=0)
    s = np.where(finite, path, 0.0).sum(axis=0)
    with np.errstate(invalid="ignore"):
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), UNREACHABLE)
    return mean + compute_latency_s
