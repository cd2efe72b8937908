"""Dense linear algebra over GF(2), host-side NumPy.

The pure-NumPy paths of ``tpugnn.utils.f2`` that the graph builder needs:
logical operators (``css_logicals``) and pure-error tables
(``solve_right_inverse``).  Run once per graph build; nothing here is on the
decode path.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rank", "nullspace", "solve_right_inverse", "css_logicals"]


def _as_f2(a: np.ndarray) -> np.ndarray:
    a = np.asarray(a, dtype=np.uint8) % 2
    if a.ndim != 2:
        raise ValueError(f"expected 2-D matrix, got shape {a.shape}")
    return a


def _row_reduce(a: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """Reduced row-echelon form of ``a`` over GF(2) and its pivot columns."""
    r = _as_f2(a).copy()
    m, n = r.shape
    pivots: list[int] = []
    row = 0
    for col in range(n):
        if row >= m:
            break
        sel = np.nonzero(r[row:, col])[0]
        if sel.size == 0:
            continue
        piv = row + int(sel[0])
        if piv != row:
            r[[row, piv]] = r[[piv, row]]
        mask = r[:, col].astype(bool).copy()
        mask[row] = False
        r[mask] ^= r[row]
        pivots.append(col)
        row += 1
    return r, pivots


def rank(a: np.ndarray) -> int:
    return len(_row_reduce(a)[1])


def nullspace(a: np.ndarray) -> np.ndarray:
    """Basis of the right nullspace of ``a`` over GF(2), shape [k, n]."""
    a = _as_f2(a)
    n = a.shape[1]
    r, pivots = _row_reduce(a)
    free = [c for c in range(n) if c not in pivots]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for i, fc in enumerate(free):
        basis[i, fc] = 1
        for j, pc in enumerate(pivots):
            basis[i, pc] = r[j, fc]
    if basis.size and ((basis @ a.T) % 2).any():
        raise AssertionError("nullspace verification failed")
    return basis


def _solve(a: np.ndarray, b: np.ndarray) -> np.ndarray | None:
    """One solution x of a @ x = b over GF(2), or None if inconsistent."""
    a = _as_f2(a)
    m, n = a.shape
    aug = np.hstack([a, np.asarray(b, dtype=np.uint8).reshape(m, 1)])
    r, pivots = _row_reduce(aug)
    if n in pivots:
        return None
    x = np.zeros(n, dtype=np.uint8)
    for i, pc in enumerate(pivots):
        x[pc] = r[i, n]
    return x


def solve_right_inverse(h: np.ndarray) -> np.ndarray:
    """Matrix ``T`` [n, m] with ``h @ (T @ s) == s`` for every achievable s.

    Solved over an independent row subset; columns of dependent rows stay
    zero (a unit syndrome on a dependent row is unachievable).
    """
    h = _as_f2(h)
    m, n = h.shape
    t = np.zeros((n, m), dtype=np.uint8)
    if m == 0:
        return t
    indep: list[int] = []
    acc = np.zeros((0, n), np.uint8)
    for j in range(m):
        cand = np.vstack([acc, h[j][None, :]])
        if rank(cand) > len(indep):
            indep.append(j)
            acc = cand
    h_j = h[indep]
    for i, j in enumerate(indep):
        s = np.zeros(len(indep), dtype=np.uint8)
        s[i] = 1
        e = _solve(h_j, s)
        if e is None:
            raise AssertionError("independent subsystem must be solvable")
        t[:, j] = e
    chk = (h @ t) % 2
    if any(chk[j, j] != 1 for j in indep):
        raise AssertionError("right-inverse verification failed")
    return t


def css_logicals(hx: np.ndarray, hz: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Paired logical operators ``(lx, lz)``, each [k, n], with
    ``lx @ lz.T == I (mod 2)``.

    X-logicals: ker(Hz) outside rowspace(Hx); Z-logicals: ker(Hx) outside
    rowspace(Hz).
    """
    hx = _as_f2(hx) if hx.size else np.zeros((0, hz.shape[1]), np.uint8)
    hz = _as_f2(hz) if hz.size else np.zeros((0, hx.shape[1]), np.uint8)
    n = max(hx.shape[1], hz.shape[1])
    if hx.shape[0] and hz.shape[0] and ((hx @ hz.T) % 2).any():
        raise ValueError("Hx Hz^T != 0: not a CSS code")

    def coset_reps(kernel_basis: np.ndarray, stab_rows: np.ndarray) -> np.ndarray:
        reps = []
        acc = stab_rows.copy() if stab_rows.size else np.zeros((0, n), np.uint8)
        base_rank = rank(acc) if acc.size else 0
        for v in kernel_basis:
            cand = np.vstack([acc, v[None, :]]) if acc.size else v[None, :]
            if rank(cand) > (base_rank + len(reps)):
                reps.append(v)
                acc = cand
        return np.array(reps, dtype=np.uint8).reshape(len(reps), n)

    lx = coset_reps(nullspace(hz) if hz.size else np.eye(n, dtype=np.uint8), hx)
    lz = coset_reps(nullspace(hx) if hx.size else np.eye(n, dtype=np.uint8), hz)
    k = min(len(lx), len(lz))

    # canonical pairing: row ops on lx and column ops on lz until
    # P = lx @ lz^T is the identity
    p = (lx @ lz.T) % 2
    lx = lx.copy()
    lz = lz.copy()
    for i in range(k):
        nz = np.nonzero(p[i, i:])[0]
        if nz.size == 0:
            found = False
            for i2 in range(i + 1, len(lx)):
                if p[i2, i:].any():
                    lx[[i, i2]] = lx[[i2, i]]
                    p[[i, i2]] = p[[i2, i]]
                    found = True
                    break
            if not found:
                continue
            nz = np.nonzero(p[i, i:])[0]
        j = i + int(nz[0])
        if j != i:
            lz[[i, j]] = lz[[j, i]]
            p[:, [i, j]] = p[:, [j, i]]
        for j2 in range(len(lz)):
            if j2 != i and p[i, j2]:
                lz[j2] ^= lz[i]
                p[:, j2] ^= p[:, i]
        for i2 in range(len(lx)):
            if i2 != i and p[i2, i]:
                lx[i2] ^= lx[i]
                p[i2] ^= p[i]
    lx, lz = lx[:k], lz[:k]
    if not np.array_equal((lx @ lz.T) % 2, np.eye(k, dtype=np.uint8)):
        raise AssertionError("logical pairing failed")
    return lx, lz
