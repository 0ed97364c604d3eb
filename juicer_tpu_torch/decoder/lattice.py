"""Word lattices from the decoder's lattice records.

Counterpart of `juicer_tpu/decoder/lattice.py`, itself the rebuild of the
reference's `WFSTLattice` (`writeLatticeFSM` and the per-frame
net-state -> lattice-state map). `TorchDecoder.run` with `gen_lattice`
writes flat per-frame records:

  - an EVENT for every merge-winning entry token, (frame, slot) ->
    (entered arc, cumulative acoustic and LM score): the lattice states;
  - an EDGE for every beam-surviving expansion candidate (winners and
    losers): the source token's entry-event id, the target arc, the
    candidate's cumulative scores and the crossed word labels;
  - a FINAL EDGE for every final-state candidate of the last frame.

`build_lattice` assembles them on the host: edge weight = candidate
cumulative minus source-event cumulative (negated on write); input label
= the entered arc's model + 1; multi-word label sequences are factored
into epsilon chains; the caller removes the dead ends in one trim
(`fst.algos.connect`).
Records are read for one utterance (the B=1 slice of `run`'s planes).
Events are keyed by (frame, arc, G state): with on-the-fly composition an
edge reaches the event of its target arc in its G state (`lat_to_g`,
`ev_g`); without a G every G state is 0.
"""

from __future__ import annotations

import numpy as np

from ..fst import EPSILON, LOG, Fst, write_fsm
from .artifact import DecoderArtifact

def build_lattice(art: DecoderArtifact, ys: dict, rec0: dict, T: int) -> Fst:
    """Assemble a lattice Fst from one utterance's lattice records: `ys`
    holds `LAT_FIELDS` (T, E), `FLAT_FIELDS` (T, F) and `EV_FIELDS` (T, K)
    of `decoder.core` (with a G also `lat_to_g` and `ev_g`), `rec0` the
    initial propagation's (E) edges and (K) events. The dead ends stay:
    `algos.connect` removes them, as `TorchDecoder.decode_scores_lattice`
    does."""
    seqs = art.seqs
    K = len(np.asarray(rec0["ev_arc"]))
    otf = "ev_g" in rec0

    def g_of(part, name, like):
        return np.asarray(part[name]) if otf else np.zeros(np.shape(like), np.int64)

    # ---- event table: ev_id -> (arc, cum_ac, cum_lm, fst state) ----------
    ev_arc0 = np.asarray(rec0["ev_arc"])
    ev_ac0 = np.asarray(rec0["ev_ac"])
    ev_lm0 = np.asarray(rec0["ev_lm"])
    ev_arc = np.asarray(ys["ev_arc"]) if T > 0 else np.zeros((0, K), np.int32)
    ev_ac = np.asarray(ys["ev_ac"]) if T > 0 else np.zeros((0, K))
    ev_lm = np.asarray(ys["ev_lm"]) if T > 0 else np.zeros((0, K))
    ev_g0 = g_of(rec0, "ev_g", ev_arc0)
    ev_g = g_of(ys, "ev_g", ev_arc) if T > 0 else np.zeros((0, K), np.int64)

    f = Fst(LOG)
    start = f.add_state()
    f.set_start(start)

    ev_state: dict[int, int] = {}
    ev_cum: dict[int, float] = {}
    by_key: dict[tuple, int] = {}  # (frame, arc, G state) -> event

    def register_events(t: int, arcs, acs, lms, gs):
        for slot in np.nonzero(arcs >= 0)[0]:
            ev = t * K + int(slot)
            ev_state[ev] = f.add_state()
            ev_cum[ev] = float(acs[slot]) + float(lms[slot])
            by_key[(t, int(arcs[slot]), int(gs[slot]))] = ev

    register_events(-1, ev_arc0, ev_ac0, ev_lm0, ev_g0)
    for t in range(T):
        register_events(t, ev_arc[t], ev_ac[t], ev_lm[t], ev_g[t])

    def src_of(ev: int):
        # -1 is the utterance start (as in the JAX engine, where the
        # initial propagation's event in slot K-1 shares that id)
        if ev == -1:
            return start, 0.0
        s = ev_state.get(ev)
        return (s, ev_cum[ev]) if s is not None else (None, 0.0)

    def add_edge(src, dst, in_label, labels, cost):
        if len(labels) <= 1:
            f.add_arc(src, dst, in_label, int(labels[0]) if labels else EPSILON, cost)
            return
        cur = src
        for i, lab in enumerate(labels):
            last = i == len(labels) - 1
            nxt = dst if last else f.add_state()
            f.add_arc(cur, nxt, in_label if i == 0 else EPSILON, int(lab),
                      cost if i == 0 else 0.0)
            cur = nxt

    # ---- edges -----------------------------------------------------------
    def emit_edges(t, from_ev, to_arc, ac, lm, seq, valid, to_g):
        for e in np.nonzero(valid)[0]:
            src, src_cum = src_of(int(from_ev[e]))
            if src is None:
                continue
            ev = by_key.get((t, int(to_arc[e]), int(to_g[e])))
            if ev is None:
                continue  # target arc's winner overflowed the frontier
            dst = ev_state[ev]
            cost = -((float(ac[e]) + float(lm[e])) - src_cum)
            in_label = int(art.arc_hmm[int(to_arc[e])]) + 1
            add_edge(src, dst, in_label, seqs[int(seq[e])], cost)

    if "lat_valid" in rec0:
        emit_edges(
            -1,
            np.asarray(rec0["lat_from_ev"]), np.asarray(rec0["lat_to_arc"]),
            np.asarray(rec0["lat_ac"]), np.asarray(rec0["lat_lm"]),
            np.asarray(rec0["lat_seq"]), np.asarray(rec0["lat_valid"]),
            g_of(rec0, "lat_to_g", rec0["lat_valid"]),
        )
    if T > 0:
        lf = np.asarray(ys["lat_from_ev"])
        lt = np.asarray(ys["lat_to_arc"])
        la = np.asarray(ys["lat_ac"])
        ll = np.asarray(ys["lat_lm"])
        ls = np.asarray(ys["lat_seq"])
        lv = np.asarray(ys["lat_valid"])
        lg = g_of(ys, "lat_to_g", lv)
        for t in range(T):
            emit_edges(t, lf[t], lt[t], la[t], ll[t], ls[t], lv[t], lg[t])

        # ---- final states from the LAST frame's final candidates ---------
        fv = np.asarray(ys["flat_valid"])[T - 1]
        fe = np.asarray(ys["flat_from_ev"])[T - 1]
        fa = np.asarray(ys["flat_ac"])[T - 1]
        fl = np.asarray(ys["flat_lm"])[T - 1]
        fs = np.asarray(ys["flat_seq"])[T - 1]
        for e in np.nonzero(fv)[0]:
            src, src_cum = src_of(int(fe[e]))
            if src is None:
                continue
            cost = -((float(fa[e]) + float(fl[e])) - src_cum)
            labels = seqs[int(fs[e])]
            if labels:
                end = f.add_state()
                add_edge(src, end, EPSILON, labels, cost)
                f.set_final(end, 0.0)
            else:
                w = f.final_weight(src)
                f.set_final(src, min(w, cost) if w < 1e29 else cost)
    return f


def write_lattice(lattice: Fst, path: str) -> None:
    """FSM-format lattice output (`writeLatticeFSM`)."""
    write_fsm(lattice, path)


def _topo_order(lattice: Fst) -> tuple[np.ndarray, list[list[int]]]:
    """Topological order of an acyclic lattice (Kahn) and its per-state
    out-arc lists. Lattice states are time-layered so cycles cannot occur;
    raises if one does."""
    adj = lattice.out_arcs()
    dst = lattice.arc_dst
    indeg = np.zeros(lattice.num_states, dtype=np.int64)
    np.add.at(indeg, np.asarray(dst, dtype=np.int64), 1)
    stack = list(np.nonzero(indeg == 0)[0])
    order = []
    while stack:
        s = int(stack.pop())
        order.append(s)
        for i in adj[s]:
            d = dst[i]
            indeg[d] -= 1
            if indeg[d] == 0:
                stack.append(d)
    if len(order) != lattice.num_states:
        raise ValueError("lattice has a cycle")
    return np.asarray(order), adj


def shortest_path(lattice: Fst) -> tuple[float, list[int]]:
    """Tropical best path: returns (cost, output label sequence). The
    verification counterpart of the decoder's 1-best: on a correct
    lattice these equal -DecodeResult.score and DecodeResult.words.
    One pass in topological order, linear in the lattice, with the JAX
    lattice module's tie-breaking; `fst.algos.shortest_path` is the
    queue-based search for FSTs that may have cycles."""
    src, dst, ol = lattice.arc_src, lattice.arc_dst, lattice.arc_olabel
    w = np.asarray(lattice.arc_weight, dtype=np.float64)
    n = lattice.num_states
    INF = np.inf
    dist = np.full(n, INF)
    back = np.full(n, -1, dtype=np.int64)
    dist[lattice.start] = 0.0
    order, adj = _topo_order(lattice)
    for s in order:
        if dist[s] == INF:
            continue
        for i in adj[s]:
            nd = dist[s] + w[i]
            if nd < dist[dst[i]]:
                dist[dst[i]] = nd
                back[dst[i]] = i
    best_s, best_c = -1, INF
    for s, fw in lattice.finals.items():
        c = dist[s] + fw
        if c < best_c:
            best_s, best_c = s, c
    labels: list[int] = []
    s = best_s
    while s >= 0 and back[s] >= 0:
        i = int(back[s])
        if ol[i] != EPSILON:
            labels.append(int(ol[i]))
        s = int(src[i])
    return float(best_c), labels[::-1]


def contains_cost(lattice: Fst, labels: list[int]) -> float:
    """Best path cost of exactly `labels` through the lattice (inf if the
    sequence is not encoded) — the oracle-coverage probe: a lattice
    covers the reference transcript iff this is finite."""
    dst, ol = lattice.arc_dst, lattice.arc_olabel
    w = np.asarray(lattice.arc_weight, dtype=np.float64)
    INF = np.inf
    L = len(labels)
    # dist[s, k] = best cost reaching state s having consumed labels[:k]
    dist = np.full((lattice.num_states, L + 1), INF)
    dist[lattice.start, 0] = 0.0
    order, adj = _topo_order(lattice)
    for s in order:
        row = dist[s]
        if not np.isfinite(row).any():
            continue
        for i in adj[s]:
            d = dst[i]
            if ol[i] == EPSILON:
                np.minimum(dist[d], row + w[i], out=dist[d])
            else:
                ks = np.nonzero(np.isfinite(row[:L]))[0]
                for k in ks:
                    if labels[k] == ol[i]:
                        nd = row[k] + w[i]
                        if nd < dist[d, k + 1]:
                            dist[d, k + 1] = nd
    best = INF
    for s, fw in lattice.finals.items():
        best = min(best, dist[s, L] + fw)
    return float(best)
