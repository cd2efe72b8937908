"""On-device residual repair: batched greedy defect pairing in tensor ops.

The port of ``tpugnn.baselines.device_repair``.  The GNN leaves a sparse
residual syndrome; this repairs it on the card, inside the decode program,
so that no residual crosses to the host.  It is not union-find: it is a
fixed-iteration greedy matcher in batched tensor ops.

* **Static tables** (host precompute, once per graph; NumPy): all-pairs BFS
  distances ``dist`` on each sector's decoding graph (vertices = checks + one
  virtual boundary, edges = qubits, the graph of
  ``baselines.union_find._sector_edges``), the XOR edge set of one shortest
  path per vertex pair (``[(nv+1)^2, n]`` uint8), and the GF(2) path-to-root
  rows ``a_root`` that clear a single defect at check c.
* **K rounds of masked min-plus argmin** (a Python loop of ``k_iters``
  tensor steps): each round every shot takes its globally closest defect
  pair (or defect and boundary), XORs the stored path into its correction
  and clears the pair.
* **Validity fallback**: the defects left after K rounds are routed to the
  root through ``a_root`` (one f32 product, exact: the sums stay below
  n << 2^24), so the correction ALWAYS reproduces the residual syndrome.
* **Exact small sets**: shots with at most 4 defects take the cheapest of
  the 10 ways to resolve 4 slots (3 pairings, 6 one-pair-two-boundary,
  all-boundary) in place of the greedy answer.

Ties resolve as in JAX: ``torch.argmin`` returns the first minimum and the
defect slots come from a stable sort, so the same residuals give the same
corrections bit for bit.  Plain torch ops, as JAX computes it in ``jnp``
outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpugnn_torch.baselines.union_find import _sector_edges
from tpugnn_torch.tanner.graph import TannerGraph
from tpugnn_torch.utils.device import resolve_device

__all__ = ["DeviceRepair"]

_INF = 1.0e9

# the ways to resolve 4 defect slots: PARTNERS[r][slot] = partner slot, or
# -1 for the boundary
_PARTNERS = (
    (1, 0, 3, 2), (2, 3, 0, 1), (3, 2, 1, 0),           # two pairs
    (1, 0, -1, -1), (2, -1, 0, -1), (3, -1, -1, 0),      # one pair
    (-1, 2, 1, -1), (-1, 3, -1, 1), (-1, -1, 3, 2),
    (-1, -1, -1, -1),                                    # all boundary
)


def _sector_tables(eu: np.ndarray, ev: np.ndarray, nv: int, n: int):
    """BFS tables for one sector's decoding graph.

    Returns (dist [nv+1, nv+1] f32, paths [(nv+1)*(nv+1), n] uint8,
    a_root [nv, n] uint8, has_boundary).  Vertex ``nv`` is the virtual
    boundary (all weight-1 qubits attach to it).  ``paths[i*(nv+1)+j]`` is
    the qubit XOR set of one shortest i->j path (zeros when unreachable:
    callers mask by dist < INF).
    """
    nb = nv + 1
    adj: list[list[tuple[int, int]]] = [[] for _ in range(nb)]
    for q in range(len(eu)):
        u, v = int(eu[q]), int(ev[q])
        if u < 0:
            continue
        w = v if v >= 0 else nv  # boundary edge
        adj[u].append((w, q))
        adj[w].append((u, q))

    dist = np.full((nb, nb), _INF, np.float32)
    pred_q = np.full((nb, nb), -1, np.int64)  # edge taken INTO j from src i
    pred_v = np.full((nb, nb), -1, np.int64)
    for src in range(nb):
        dist[src, src] = 0.0
        frontier = [src]
        while frontier:
            nxt = []
            for u in frontier:
                for (w, q) in adj[u]:
                    if dist[src, w] >= _INF:
                        dist[src, w] = dist[src, u] + 1.0
                        pred_q[src, w] = q
                        pred_v[src, w] = u
                        nxt.append(w)
            frontier = nxt

    paths = np.zeros((nb * nb, n), np.uint8)
    for i in range(nb):
        for j in range(nb):
            if dist[i, j] >= _INF or i == j:
                continue
            w = j
            while w != i:
                paths[i * nb + j, pred_q[i, w]] ^= 1
                w = int(pred_v[i, w])

    # root for the validity fallback: the boundary if this sector has one,
    # else vertex 0 (toric-style sectors always have even defect parity, so
    # per-shot root flips cancel pairwise)
    has_boundary = bool((np.asarray(ev) < 0).any() and (np.asarray(eu) >= 0).any())
    root = nv if has_boundary else 0
    a_root = np.stack([paths[c * nb + root] for c in range(nv)]) \
        if nv > 0 else np.zeros((0, n), np.uint8)
    return dist, paths, a_root, has_boundary


def _repair_sector(defects: torch.Tensor, dist: torch.Tensor, paths: torch.Tensor,
                   a_root: torch.Tensor, has_boundary: bool, k_iters: int) -> torch.Tensor:
    """Batched greedy pairing for one sector.

    defects: [B, nv] 0/1 f32; ``paths`` and ``a_root`` as f32 0/1 tensors.
    Returns [B, n] 0/1 f32 corrections whose sector syndrome equals
    ``defects`` exactly.
    """
    nv = dist.shape[0] - 1
    n = paths.shape[-1]
    B = defects.shape[0]
    dev = defects.device
    if nv == 0:
        return torch.zeros((B, n), dtype=torch.float32, device=dev)
    d_pair = dist[:nv, :nv] + torch.eye(nv, dtype=torch.float32, device=dev) * _INF
    d_bnd = dist[:nv, nv] if has_boundary else torch.full((nv,), _INF, device=dev)
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    ar = torch.arange(B, device=dev)

    v = defects.float()
    acc = torch.zeros((B, n), dtype=torch.float32, device=dev)
    for _ in range(k_iters):
        on = v > 0.5
        # closest defect partner for every defect vertex (masked min-plus)
        cand = torch.where(on[:, None, :], d_pair[None, :, :], inf)
        best_j = cand.amin(dim=2)                            # [B, nv]
        arg_j = cand.argmin(dim=2)                           # [B, nv]
        # actions are valued PER DEFECT CLEARED: a pair clears two at D_ij,
        # a boundary route clears one at D_ib
        use_b = d_bnd[None, :] < best_j * 0.5
        cost = torch.where(use_b, d_bnd[None, :], best_j * 0.5)
        cost = torch.where(on, cost, inf)
        i_star = torch.argmin(cost, dim=1)                   # [B]
        c_star = cost[ar, i_star]
        valid = c_star < _INF * 0.5
        j_star = arg_j[ar, i_star]
        b_star = use_b[ar, i_star]
        j_eff = torch.where(b_star, torch.full_like(j_star, nv), j_star)
        path = paths.index_select(0, i_star * (nv + 1) + j_eff)   # a row per shot
        acc = acc + path * valid[:, None].float()
        hit_i = F.one_hot(i_star, nv).float() * valid[:, None].float()
        hit_j = F.one_hot(j_star, nv).float() * (valid & ~b_star)[:, None].float()
        v = torch.clamp(v - hit_i - hit_j, 0.0, 1.0)
    # validity fallback: route every leftover defect to the root
    acc = acc + v @ a_root
    greedy = torch.remainder(acc, 2.0)

    # EXACT minimum-cost resolution for shots with <= 4 defects: enumerate
    # the 10 ways to resolve 4 slots and take the cheapest TOTAL; shots with
    # more defects (or no feasible resolution) keep the greedy answer
    v0 = defects.float()
    cnt = v0.sum(dim=1)
    order = torch.argsort(-v0, dim=1, stable=True)[:, :4]    # defect slots
    val = torch.gather(v0, 1, order) > 0.5                    # [B, 4]
    d4 = dist[order[:, :, None], order[:, None, :]]           # [B, 4, 4]
    b4 = d_bnd[order]                                         # [B, 4]
    both = val[:, :, None] & val[:, None, :]
    neither = ~val[:, :, None] & ~val[:, None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    pairc = torch.where(both, d4, torch.where(neither, zero, inf))
    bndc = torch.where(val, b4, zero)
    costs = []
    for r in range(len(_PARTNERS)):
        c = 0.0
        for s in range(4):
            j = _PARTNERS[r][s]
            if j == -1:
                c = c + bndc[:, s]
            elif j > s:
                c = c + pairc[:, s, j]
        costs.append(c)
    costs = torch.stack(costs, dim=1)                         # [B, 10]
    r_star = torch.argmin(costs, dim=1)
    c_tot = costs[ar, r_star]
    partner = torch.tensor(_PARTNERS, dtype=torch.int64, device=dev)[r_star]  # [B, 4]
    acc_e = torch.zeros((B, n), dtype=torch.float32, device=dev)
    for s in range(4):
        j = partner[:, s]
        use = val[:, s] & ((j < 0) | (j > s))   # XOR each pair path once
        idx_s = order[:, s]
        idx_j = torch.where(j < 0, torch.full_like(j, nv),
                            torch.gather(order, 1, j.clamp(0, 3)[:, None])[:, 0])
        path = paths.index_select(0, idx_s * (nv + 1) + idx_j)
        acc_e = acc_e + path * use[:, None].float()
    exact = torch.remainder(acc_e, 2.0)
    use_exact = (cnt <= 4.5) & (c_tot < _INF * 0.5)
    return torch.where(use_exact[:, None], exact, greedy)


class DeviceRepair:
    """Two-sector on-device residual repair over a TannerGraph.

    Same sector split as ``UnionFindDecoder`` (X errors flip Z-type checks
    and vice versa).  The tables live on ``device`` (the card unless the
    caller asks for the CPU); ``repair`` takes residuals on that device.
    """

    def __init__(self, graph: TannerGraph, *, k_iters: int = 8, device="cuda"):
        self.graph = graph
        self.k_iters = int(k_iters)
        self.device = resolve_device(device)
        mx = graph.n_checks_x
        m, n = graph.n_checks, graph.n_qubits
        hx = np.asarray(graph.h_syn_ez)[:mx, :n].astype(np.uint8)
        hz = np.asarray(graph.h_syn_ex)[mx:m, :n].astype(np.uint8)
        self._mx, self._m, self._n = mx, m, n
        self._n_pad = graph.n_qubits_pad
        # X sector decodes s_z (rows mx..m), Z sector decodes s_x (rows 0..mx)
        xd, xp, xa, xb = _sector_tables(*_sector_edges(hz), hz.shape[0], n)
        zd, zp, za, zb = _sector_tables(*_sector_edges(hx), hx.shape[0], n)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=self.device)
        self._x = (as_t(xd), as_t(xp), as_t(xa), xb)
        self._z = (as_t(zd), as_t(zp), as_t(za), zb)

    def repair(self, syndrome: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, m_pad] residual syndrome -> (ex, ez) [B, n_pad] f32
        corrections with ``H (ex, ez) == syndrome`` exactly (mod 2)."""
        s = syndrome[:, : self._m]
        s_x, s_z = s[:, : self._mx], s[:, self._mx:]
        ex = _repair_sector(s_z, *self._x, self.k_iters)
        ez = _repair_sector(s_x, *self._z, self.k_iters)
        pad = self._n_pad - self._n
        if pad > 0:
            ex = F.pad(ex, (0, pad))
            ez = F.pad(ez, (0, pad))
        return ex, ez
