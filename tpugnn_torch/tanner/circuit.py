"""Circuit-level noise: detector graphs from syndrome-extraction faults.

The port's copy of ``tpugnn.tanner.circuit``.  The phenomenological model
(``tanner/spacetime.py``) has two fault species: data flips between rounds
and measurement flips.  Real extraction circuits add the rest: every CNOT of
the stabilizer-measurement schedule can depolarize, and a fault on an
ancilla mid-schedule propagates through the ancilla's *remaining* CNOTs onto
several data qubits at once (the "hook" errors).  None of this changes the
decoding problem's shape: faults are still independent binary variables and
detectors parities of fault subsets, so the result is one more parity-check
matrix over fault classes, and the decoder, the fused rounds, the LER
harness and the classical baselines run on it unchanged.

Construction (single CSS sector, standard detector-error-model recipe):

1. Enumerate *elementary faults* of one Pauli type (X for ``sector='z'``)
   over ``d_t - 1`` noisy extraction rounds + one perfect readout round:
     - data-qubit idle depolarizing before each round  (scale 2/3: X or Y)
     - two-qubit depolarizing on each scheduled CNOT, split into its three
       X-component classes {ctrl only, tgt only, both}  (scale 4/15 each)
     - own-sector ancilla prep flip and measurement flip (scale 1 each)
2. Propagate each fault through the remainder of the circuit:
     - an X landing on a data qubit after layer ``l`` of round ``t`` is
       first seen by an own-sector check ``c`` at round ``t`` if the
       (c, q) CNOT is scheduled later (``s(c, q) > l``), else ``t + 1``;
       persistent flips difference out to a SINGLE detector (c, r).
     - a fault on an *other*-sector ancilla after layer ``l`` copies onto
       that stabilizer's data partners scheduled at layers ``> l`` (hook).
     - own-sector ancilla faults flip that round's outcome: detectors
       (c, t) and (c, t + 1).
3. Merge faults with identical (detector symptom, logical effect) into one
   fault class; class rate = sum of member scales (first order in p, the
   standard DEM approximation).  Columns of H' are the symptoms; the
   graph's logicals are the per-class logical effects, so the LER harness's
   failure test <L, f XOR f_hat> is exact on fault vectors.

Sampling draws fault class ``j`` with probability ``p * rate_scale[j]``
through the graph's ``rate_scale`` (``sampling/noise.py``).
"""

from __future__ import annotations

import numpy as np

from tpugnn_torch.tanner.graph import TannerGraph, build_tanner_graph
from tpugnn_torch.utils import f2

__all__ = [
    "surface_schedule", "toric_schedule", "repetition_schedule",
    "elementary_faults", "fault_effect",
    "circuit_fault_classes", "build_circuit_code",
]

# relative fault-probability scales (units of the physical rate p)
SCALE_IDLE = 2.0 / 3.0   # data depolarizing: X or Y component
SCALE_CNOT = 4.0 / 15.0  # two-qubit depolarizing: each X-component class
SCALE_PREP = 1.0
SCALE_MEAS = 1.0


def surface_schedule(d: int) -> tuple[list[list[tuple[int, int]]], list[list[tuple[int, int]]]]:
    """(x_sched, z_sched): per check row, its [(data qubit, CNOT layer)].

    Row order matches ``tanner/surface.py::surface_code_checks`` exactly (same
    plaquette enumeration).  Layers follow the Tomita–Svore compatible
    pair of orders over plaquette corners — X-type: NW, NE, SW, SE
    ("N"-shaped); Z-type: NW, SW, NE, SE ("Z"-shaped) — boundary
    plaquettes keep the layer indices of their surviving corners.
    """
    if d < 2:
        raise ValueError("surface code needs d >= 2")

    def qid(r: int, c: int) -> int:
        return r * d + c

    x_sched: list[list[tuple[int, int]]] = []
    z_sched: list[list[tuple[int, int]]] = []
    for i in range(d + 1):
        for j in range(d + 1):
            nw, ne = (i - 1, j - 1), (i - 1, j)
            sw, se = (i, j - 1), (i, j)
            is_x = (i + j) % 2 == 0
            corners = [nw, ne, sw, se] if is_x else [nw, sw, ne, se]
            qs = [
                (qid(r, c), layer)
                for layer, (r, c) in enumerate(corners)
                if 0 <= r < d and 0 <= c < d
            ]
            if len(qs) < 2:
                continue
            if len(qs) == 2:
                on_tb = i == 0 or i == d
                if on_tb and not is_x:
                    continue
                if not on_tb and is_x:
                    continue
            (x_sched if is_x else z_sched).append(qs)
    return x_sched, z_sched


def toric_schedule(d: int) -> tuple[list[list[tuple[int, int]]], list[list[tuple[int, int]]]]:
    """(x_sched, z_sched) for the d x d toric code, 4 CNOT layers.

    Row order matches ``tanner/toric.py::toric_code_checks`` exactly (vertex /
    plaquette index r*d + c; horizontal edge (r, c) -> r*d + c, vertical ->
    d*d + r*d + c, coordinates mod d).  The classic interleaving: in every
    layer the vertex (X) ancillas touch one full orientation class of edges
    and the plaquette (Z) ancillas the other, so no data qubit does two
    CNOTs in a layer:

        layer     0           1           2           3
        vertex    N=v(r-1,c)  W=h(r,c-1)  E=h(r,c)    S=v(r,c)
        plaq.     N=h(r,c)    W=v(r,c)    E=v(r,c+1)  S=h(r+1,c)
    """
    if d < 2:
        raise ValueError("toric code needs d >= 2")

    def hq(r: int, c: int) -> int:
        return (r % d) * d + (c % d)

    def vq(r: int, c: int) -> int:
        return d * d + (r % d) * d + (c % d)

    x_sched: list[list[tuple[int, int]]] = []
    z_sched: list[list[tuple[int, int]]] = []
    for r in range(d):
        for c in range(d):
            x_sched.append(
                [(vq(r - 1, c), 0), (hq(r, c - 1), 1), (hq(r, c), 2), (vq(r, c), 3)]
            )
            z_sched.append(
                [(hq(r, c), 0), (vq(r, c), 1), (vq(r, c + 1), 2), (hq(r + 1, c), 3)]
            )
    return x_sched, z_sched


def repetition_schedule(d: int) -> tuple[list[list[tuple[int, int]]], list[list[tuple[int, int]]]]:
    """(x_sched, z_sched) for the d-qubit repetition (bit-flip) code.

    Two CNOT layers: Z-check c reads data qubit c at layer 0 and c+1 at
    layer 1 (qubit q serves check q at layer 0 and check q-1 at layer 1 —
    no qubit does two CNOTs in one layer).  There are no X-type checks.
    """
    if d < 2:
        raise ValueError("repetition code needs d >= 2")
    return [], [[(c, 0), (c + 1, 1)] for c in range(d - 1)]


def elementary_faults(
    own_sched: list[list[tuple[int, int]]],
    other_sched: list[list[tuple[int, int]]],
    n_data: int,
    d_t: int,
) -> list[tuple[list[tuple], float]]:
    """Enumerate elementary single-location faults as physical primitives.

    Each fault is (primitives, scale); a primitive is one of
        ("data", q, t, after_layer)  — X lands on data qubit q in round t
                                       after CNOT layer ``after_layer``
                                       (-1 = before the round's layers)
        ("ownmeas", c, t)            — own-sector check c's outcome at
                                       round t flips (prep/meas/ancilla-X)
        ("otheranc", j, t, after_layer) — X lands on other-sector ancilla j
                                       after layer ``after_layer`` and
                                       propagates through its remaining
                                       CNOTs (hook source)
    Circuit faults occur in rounds 0..d_t-2 (final round perfect); data
    idles occur before every round including the last — the convention of
    ``tanner/spacetime.py::spacetime_matrix``.
    """
    if d_t < 1:
        raise ValueError("need d_t >= 1 rounds")
    faults: list[tuple[list[tuple], float]] = []
    for t in range(d_t):
        for q in range(n_data):
            faults.append(([("data", q, t, -1)], SCALE_IDLE))
        if t >= d_t - 1:
            continue  # final round is perfect: no circuit faults
        for c, qs in enumerate(own_sched):
            faults.append(([("ownmeas", c, t)], SCALE_PREP))
            faults.append(([("ownmeas", c, t)], SCALE_MEAS))
            # CNOT (data <-> own ancilla) at layer s: X-component classes
            for q, s in qs:
                faults.append(([("data", q, t, s)], SCALE_CNOT))
                faults.append(([("ownmeas", c, t)], SCALE_CNOT))
                faults.append(
                    ([("data", q, t, s), ("ownmeas", c, t)], SCALE_CNOT)
                )
        for j, qs in enumerate(other_sched):
            # CNOT (other ancilla <-> data) at layer s: ancilla X copies
            # onto partners scheduled later (hook); other-sector outcomes
            # are not our detectors
            for q, s in qs:
                faults.append(([("data", q, t, s)], SCALE_CNOT))
                faults.append(([("otheranc", j, t, s)], SCALE_CNOT))
                faults.append(
                    ([("otheranc", j, t, s), ("data", q, t, s)], SCALE_CNOT)
                )
    return faults


def fault_effect(
    prims: list[tuple],
    own_sched: list[list[tuple[int, int]]],
    other_sched: list[list[tuple[int, int]]],
    n_data: int,
    d_t: int,
) -> tuple[frozenset[int], frozenset[int]] | None:
    """(detector symptom, net data error) of one fault, in closed form.

    A persistent data flip injected after layer ``l`` of round ``t`` is
    first read by own-check ``c`` at round ``t`` if the (c, q) CNOT runs
    later in the schedule, else at ``t + 1``; consecutive-difference
    detectors therefore fire exactly once per adjacent check.  Validated
    against an explicit layer-by-layer simulation (tests/test_torch_circuit.py).
    Returns None for faults with no observable effect.
    """
    m = len(own_sched)
    own_of: list[list[tuple[int, int]]] = [[] for _ in range(n_data)]
    for c, qs in enumerate(own_sched):
        for q, layer in qs:
            own_of[q].append((c, layer))

    def injection_dets(q: int, t: int, after_layer: int) -> set[int]:
        out = set()
        for c, s in own_of[q]:
            r = t if s > after_layer else t + 1
            if r < d_t:
                out.add(r * m + c)
        return out

    sym: set[int] = set()
    err: set[int] = set()
    for prim in prims:
        if prim[0] == "data":
            _, q, t, lay = prim
            sym ^= injection_dets(q, t, lay)
            err ^= {q}
        elif prim[0] == "ownmeas":
            _, c, t = prim
            sym ^= {t * m + c} | ({(t + 1) * m + c} if t + 1 < d_t else set())
        elif prim[0] == "otheranc":
            _, j, t, lay = prim
            for q2, s2 in other_sched[j]:
                if s2 > lay:  # ancilla X copied onto later partners
                    sym ^= injection_dets(q2, t, s2)
                    err ^= {q2}
        else:  # pragma: no cover
            raise ValueError(f"unknown primitive {prim!r}")
    if not (sym or err):
        return None
    return frozenset(sym), frozenset(err)


def circuit_fault_classes(
    own_sched: list[list[tuple[int, int]]],
    other_sched: list[list[tuple[int, int]]],
    n_data: int,
    d_t: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Detector matrix over merged circuit-fault classes for one sector.

    ``own_sched``: schedules of the checks whose outcomes form the
    detectors (Z-type for the X-error sector); ``other_sched``: the
    opposite type (hook sources).  Returns (hp [m*d_t, n_classes],
    e_net [n_classes, n_data], rate_scale [n_classes]).  Faults with
    identical (symptom, net data error) merge into one class whose rate is
    the sum of member scales (first order in p); the closed-form symptom
    rules here are validated against an explicit layer-by-layer circuit
    simulation (tests/test_torch_circuit.py).
    """
    m = len(own_sched)
    classes: dict[tuple, float] = {}
    for prims, scale in elementary_faults(own_sched, other_sched, n_data, d_t):
        key = fault_effect(prims, own_sched, other_sched, n_data, d_t)
        if key is None:
            continue
        classes[key] = classes.get(key, 0.0) + scale

    keys = sorted(classes.keys(), key=lambda k: (sorted(k[0]), sorted(k[1])))
    n_cls = len(keys)
    hp = np.zeros((m * d_t, n_cls), np.uint8)
    e_net = np.zeros((n_cls, n_data), np.uint8)
    rate = np.zeros(n_cls, np.float32)
    for j, key in enumerate(keys):
        sym, err = key
        hp[sorted(sym), j] = 1
        e_net[j, sorted(err)] = 1
        rate[j] = classes[key]
    return hp, e_net, rate


def build_circuit_code(
    family: str,
    distance: int,
    d_t: int,
    *,
    sector: str = "z",
    pad_nodes: int = 8,
    pad_edges: int = 128,
) -> TannerGraph:
    """Circuit-level detector graph for ``d_t`` rounds of one sector.

    ``sector='z'`` decodes X-type circuit faults via the Z-stabilizer
    outcome detectors ('x' the converse; the two sectors are exactly dual
    under swapping the CNOT propagation direction, so one construction
    serves both with the schedules swapped).
    """
    if family == "surface":
        from tpugnn_torch.tanner import surface

        hx, hz = surface.surface_code_checks(distance)
        x_sched, z_sched = surface_schedule(distance)
    elif family == "toric":
        from tpugnn_torch.tanner import toric

        hx, hz = toric.toric_code_checks(distance)
        x_sched, z_sched = toric_schedule(distance)
    elif family == "repetition":
        from tpugnn_torch.tanner import repetition

        hx, hz = repetition.repetition_code_checks(distance)
        x_sched, z_sched = repetition_schedule(distance)
    else:
        raise ValueError(
            "circuit-level noise is implemented for family='surface', "
            "'toric' and 'repetition' (CNOT schedules are geometry-"
            "specific); phenomenological spacetime graphs (tanner."
            "spacetime) cover the other families"
        )
    assert len(x_sched) == hx.shape[0] and len(z_sched) == hz.shape[0]
    # schedule/back-matrix consistency: supports must match row for row
    for sched, hmat in ((x_sched, hx), (z_sched, hz)):
        for c, qs in enumerate(sched):
            assert sorted(q for q, _ in qs) == sorted(np.nonzero(hmat[c])[0].tolist())

    if sector == "z":
        own, other = z_sched, x_sched
    elif sector == "x":
        own, other = x_sched, z_sched
    else:
        raise ValueError("sector must be 'x' or 'z'")
    if not own:
        raise ValueError(f"{family} has no {sector}-sector checks")
    n = hx.shape[1]
    hp, e_net, rate = circuit_fault_classes(own, other, n, d_t)

    base_lx, base_lz = f2.css_logicals(hx, hz)
    base = base_lz if sector == "z" else base_lx
    k = base.shape[0]
    # logical effect of each fault class: <L, e_net> over GF(2)
    lifted = (base @ e_net.T % 2).astype(np.uint8)  # [k, n_classes]

    # drop zero-symptom classes: these are hook faults whose net data error
    # is a full stabilizer (e.g. a 'both' CNOT fault covering an entire
    # other-sector plaquette at small d_t) — undetectable AND logically
    # trivial, hence decoding-irrelevant.  A zero-symptom class with a
    # nonzero logical effect would mean the schedule breaks the code.
    detectable = hp.sum(0) > 0
    assert not lifted[:, ~detectable].any(), (
        "undetectable fault class with nonzero logical effect — invalid schedule"
    )
    hp, e_net = hp[:, detectable], e_net[detectable]
    rate, lifted = rate[detectable], lifted[:, detectable]
    logicals = (np.zeros_like(lifted), lifted)

    return build_tanner_graph(
        np.zeros((0, hp.shape[1]), np.uint8),
        hp,
        name=f"{family}_d{distance}_circuit_t{d_t}_{sector}",
        pad_nodes=pad_nodes,
        pad_edges=pad_edges,
        logicals=logicals,
        rate_scale=rate,
    )
