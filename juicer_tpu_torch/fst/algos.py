"""WFST algorithms, as in `juicer_tpu/fst/algos.py`: every operation of
the offline toolchain (`build_clg`, the `build-wfst` CLI) and of the
decode path's lattices.

arcsort, closure, concat, union, connect, invert, project, compose (with
the epsilon filter), input-epsilon normalisation, rmepsilon, weighted
determinization (native, `native.determinize`; `determinize_plain` is its
pure-Python plain version), encode-minimize-decode, weight pushing,
shortest distance and path, string weights and random paths
(`generate_sequences`).

They run on the host, in numpy and Python, as in the JAX package. State
numbering and arc order follow from each algorithm's traversal order
(dict insertion, FIFO queues, stable sorts, the `_KEY_DELTA` weight
quantisation, float64 sums in the same order), so every machine the port
builds equals the JAX package's arc for arc; keep those orders when
changing the code.

Transducer determinization and epsilon normalisation carry output-string
residuals ("gallic" weights) and factor multi-label outputs into chains
of epsilon-input arcs, as OpenFst does.
"""

from __future__ import annotations

import random
from collections import defaultdict, deque
from typing import Optional

from .fst import EPSILON, Fst
from .semiring import INF, TROPICAL, Semiring

# Weight quantization used in subset-construction keys (OpenFst default
# delta is 1/1024; we use a finer one since our weights are float64).
_KEY_DELTA = 1e-6
# Convergence threshold of the shortest-distance and epsilon-closure
# relaxations (an update smaller than this ends them).
_DELTA = 1e-9


def _qw(w: float) -> int:
    if w == INF:
        return 1 << 62
    return int(round(w / _KEY_DELTA))


# ---------------------------------------------------------------------------
# Structural ops
# ---------------------------------------------------------------------------


def arcsort(f: Fst, by: str = "ilabel") -> Fst:
    """Return a copy with each state's arcs sorted by ilabel or olabel."""
    idx = list(range(f.num_arcs))
    key = f.arc_ilabel if by == "ilabel" else f.arc_olabel
    idx.sort(key=lambda i: (f.arc_src[i], key[i]))
    g = Fst(f.semiring)
    g.start = f.start
    g.num_states = f.num_states
    g.finals = dict(f.finals)
    g.isyms, g.osyms = f.isyms, f.osyms
    g.arc_src = [f.arc_src[i] for i in idx]
    g.arc_dst = [f.arc_dst[i] for i in idx]
    g.arc_ilabel = [f.arc_ilabel[i] for i in idx]
    g.arc_olabel = [f.arc_olabel[i] for i in idx]
    g.arc_weight = [f.arc_weight[i] for i in idx]
    return g


def invert(f: Fst) -> Fst:
    g = f.copy()
    g.arc_ilabel, g.arc_olabel = g.arc_olabel, g.arc_ilabel
    g.isyms, g.osyms = f.osyms, f.isyms
    return g


def project(f: Fst, output: bool = False) -> Fst:
    g = f.copy()
    if output:
        g.arc_ilabel = list(g.arc_olabel)
        g.isyms = f.osyms
    else:
        g.arc_olabel = list(g.arc_ilabel)
        g.osyms = f.isyms
    return g


def connect(f: Fst) -> Fst:
    """Trim: keep states both accessible and coaccessible; renumber."""
    if f.start < 0:
        return Fst(f.semiring)
    fwd_adj: list[list[int]] = [[] for _ in range(f.num_states)]
    rev_adj: list[list[int]] = [[] for _ in range(f.num_states)]
    for i in range(f.num_arcs):
        fwd_adj[f.arc_src[i]].append(f.arc_dst[i])
        rev_adj[f.arc_dst[i]].append(f.arc_src[i])

    def bfs(starts, adj):
        seen = [False] * f.num_states
        dq = deque()
        for s in starts:
            if 0 <= s < f.num_states and not seen[s]:
                seen[s] = True
                dq.append(s)
        while dq:
            q = dq.popleft()
            for r in adj[q]:
                if not seen[r]:
                    seen[r] = True
                    dq.append(r)
        return seen

    acc = bfs([f.start], fwd_adj)
    coacc = bfs(list(f.finals), rev_adj)
    keep = [i for i in range(f.num_states) if acc[i] and coacc[i]]
    remap = {s: n for n, s in enumerate(keep)}

    g = Fst(f.semiring)
    g.isyms, g.osyms = f.isyms, f.osyms
    g.num_states = len(keep)
    g.start = remap.get(f.start, -1)
    for s, w in f.finals.items():
        if s in remap:
            g.finals[remap[s]] = w
    for i in range(f.num_arcs):
        s, d = f.arc_src[i], f.arc_dst[i]
        if s in remap and d in remap:
            g.arc_src.append(remap[s])
            g.arc_dst.append(remap[d])
            g.arc_ilabel.append(f.arc_ilabel[i])
            g.arc_olabel.append(f.arc_olabel[i])
            g.arc_weight.append(f.arc_weight[i])
    return g


def closure(f: Fst) -> Fst:
    """Kleene star (fstclosure): new start/final superstate with eps links."""
    g = f.copy()
    ns = g.add_state()
    if g.start >= 0:
        g.add_arc(ns, g.start, EPSILON, EPSILON, g.semiring.one)
    for s, w in list(g.finals.items()):
        g.add_arc(s, ns, EPSILON, EPSILON, w)
    g.set_final(ns, g.semiring.one)
    g.start = ns
    return g


def concat(a: Fst, b: Fst) -> Fst:
    """a · b via eps links from a's finals to b's start."""
    g = a.copy()
    off = g.num_states
    g.num_states += b.num_states
    for i in range(b.num_arcs):
        g.arc_src.append(b.arc_src[i] + off)
        g.arc_dst.append(b.arc_dst[i] + off)
        g.arc_ilabel.append(b.arc_ilabel[i])
        g.arc_olabel.append(b.arc_olabel[i])
        g.arc_weight.append(b.arc_weight[i])
    for s, w in list(g.finals.items()):
        if s < off:
            g.add_arc(s, b.start + off, EPSILON, EPSILON, w)
    g.finals = {s + off: w for s, w in b.finals.items()}
    return g


def union(a: Fst, b: Fst) -> Fst:
    g = a.copy()
    off = g.num_states
    g.num_states += b.num_states
    for i in range(b.num_arcs):
        g.arc_src.append(b.arc_src[i] + off)
        g.arc_dst.append(b.arc_dst[i] + off)
        g.arc_ilabel.append(b.arc_ilabel[i])
        g.arc_olabel.append(b.arc_olabel[i])
        g.arc_weight.append(b.arc_weight[i])
    for s, w in b.finals.items():
        g.finals[s + off] = w
    ns = g.add_state()
    g.add_arc(ns, a.start, EPSILON, EPSILON, g.semiring.one)
    g.add_arc(ns, b.start + off, EPSILON, EPSILON, g.semiring.one)
    g.start = ns
    return g


# ---------------------------------------------------------------------------
# Composition (Mohri 3-state epsilon filter)
# ---------------------------------------------------------------------------


def compose(a: Fst, b: Fst, connect_result: bool = True) -> Fst:
    """a ∘ b, matching a's output labels against b's input labels.

    Uses the standard epsilon filter so parallel eps paths are not
    duplicated. Filter moves:
      state 0: match, eps-eps(both), eps-a(=>1), eps-b(=>2)
      state 1: match(=>0), eps-a(=>1)
      state 2: match(=>0), eps-b(=>2)
    """
    sr = a.semiring
    a_adj = a.out_arcs()
    # bucket b's arcs by (state, ilabel) for hash join
    b_by_lab: dict[tuple[int, int], list[int]] = defaultdict(list)
    b_eps: dict[int, list[int]] = defaultdict(list)
    for i in range(b.num_arcs):
        il = b.arc_ilabel[i]
        if il == EPSILON:
            b_eps[b.arc_src[i]].append(i)
        else:
            b_by_lab[(b.arc_src[i], il)].append(i)

    g = Fst(sr)
    g.isyms, g.osyms = a.isyms, b.osyms
    smap: dict[tuple[int, int, int], int] = {}
    dq: deque[tuple[int, int, int]] = deque()

    def get_state(key):
        sid = smap.get(key)
        if sid is None:
            sid = g.add_state()
            smap[key] = sid
            dq.append(key)
        return sid

    if a.start < 0 or b.start < 0:
        return g
    g.start = get_state((a.start, b.start, 0))

    while dq:
        key = dq.popleft()
        s1, s2, fs = key
        sid = smap[key]
        fw1, fw2 = a.final_weight(s1), b.final_weight(s2)
        if fw1 != INF and fw2 != INF:
            g.finals[sid] = sr.times(fw1, fw2)

        for ai in a_adj[s1]:
            aol = a.arc_olabel[ai]
            ail = a.arc_ilabel[ai]
            adst = a.arc_dst[ai]
            aw = a.arc_weight[ai]
            if aol == EPSILON:
                # move on a alone (eps-a) -> filter 1 ; allowed from 0,1
                if fs != 2:
                    g.add_arc(sid, get_state((adst, s2, 1)), ail, EPSILON, aw)
                # both move on eps together ; allowed from 0 only
                if fs == 0:
                    for bi in b_eps.get(s2, ()):
                        g.add_arc(
                            sid,
                            get_state((adst, b.arc_dst[bi], 0)),
                            ail,
                            b.arc_olabel[bi],
                            sr.times(aw, b.arc_weight[bi]),
                        )
            else:
                for bi in b_by_lab.get((s2, aol), ()):
                    g.add_arc(
                        sid,
                        get_state((adst, b.arc_dst[bi], 0)),
                        ail,
                        b.arc_olabel[bi],
                        sr.times(aw, b.arc_weight[bi]),
                    )
        # move on b alone (eps-b) -> filter 2 ; allowed from 0,2
        if fs != 1:
            for bi in b_eps.get(s2, ()):
                g.add_arc(
                    sid,
                    get_state((s1, b.arc_dst[bi], 2)),
                    EPSILON,
                    b.arc_olabel[bi],
                    b.arc_weight[bi],
                )
    return connect(g) if connect_result else g


# ---------------------------------------------------------------------------
# Shortest distance / path
# ---------------------------------------------------------------------------


def _shortest_distance_np(
    f: Fst, reverse: bool, sr: Semiring, max_sweeps: int
) -> Optional[list[float]]:
    """Vectorized Jacobi iteration for shortest distance: one numpy
    segment-reduction per sweep instead of per-edge Python relaxation.
    The queue algorithm's geometric convergence on cyclic log-semiring
    machines (word loops with cycle mass near 1) takes thousands of
    sweeps, which at Python speed would dominate the build pipeline.
    Returns None to signal divergence (caller falls back / raises)."""
    import numpy as np

    n = f.num_states
    if n == 0:
        return []
    src = np.asarray(f.arc_src, np.int64)
    dst = np.asarray(f.arc_dst, np.int64)
    w = np.asarray(f.arc_weight, np.float64)
    base = np.full(n, np.inf)
    if reverse:
        group, nbr = src, dst
        for s, fw in f.finals.items():
            base[s] = fw if sr.name == "tropical" else _log_plus_np(base[s], fw)
    else:
        group, nbr = dst, src
        if f.start >= 0:
            base[f.start] = 0.0
    order = np.argsort(group, kind="stable")
    g_s, nbr_s, w_s = group[order], nbr[order], w[order]
    # segment boundaries per group id (empty groups -> lo == hi)
    lo = np.searchsorted(g_s, np.arange(n))
    hi = np.searchsorted(g_s, np.arange(n) + 1)
    nonempty = lo < hi
    ne_lo = lo[nonempty]
    d = base.copy()
    tropical = sr.name == "tropical"
    for _ in range(max_sweeps):
        vals = w_s + d[nbr_s]
        seg = np.full(n, np.inf)
        if len(vals):
            m = np.minimum.reduceat(vals, ne_lo) if ne_lo.size else np.array([])
            if tropical:
                seg[nonempty] = m
            else:
                # cost-domain log-sum-exp per segment, stabilized by the min
                with np.errstate(invalid="ignore", over="ignore"):
                    ex = np.exp(np.minimum(m[np.searchsorted(ne_lo, np.arange(
                        len(g_s)), side="right") - 1] - vals, 0.0))
                ex[~np.isfinite(ex)] = 0.0
                s_ = np.add.reduceat(ex, ne_lo) if ne_lo.size else np.array([])
                with np.errstate(divide="ignore", invalid="ignore"):
                    seg_ne = m - np.log(s_)
                seg_ne = np.where(np.isfinite(m), seg_ne, np.inf)
                seg[nonempty] = seg_ne
        if tropical:
            nd = np.minimum(base, seg)
        else:
            nd = _log_plus_np(base, seg)
        both_inf = np.isinf(d) & np.isinf(nd)
        with np.errstate(invalid="ignore"):
            diff = np.abs(np.where(both_inf, 0.0, d - nd))
        if np.all(both_inf | (diff <= _DELTA)):
            return [float(x) if np.isfinite(x) else INF for x in nd]
        if np.any(nd < -1e15):
            return None  # diverging (cycle mass >= 1)
        d = nd
    return None


def _log_plus_np(a, b):
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    with np.errstate(invalid="ignore", over="ignore"):
        out = lo - np.log1p(np.exp(lo - hi))
    return np.where(np.isinf(lo), hi, out)


def shortest_distance(
    f: Fst,
    reverse: bool = False,
    semiring: Optional[Semiring] = None,
    max_sweeps: int = 10000,
    dense: Optional[bool] = None,
) -> list[float]:
    """Generic single-source shortest distance (Mohri queue algorithm;
    machines beyond a few thousand arcs use the vectorized Jacobi sweep).

    Forward: distance from start to each state. Reverse: distance from each
    state to the final superstate (final weights included).
    """
    sr = semiring or f.semiring
    if dense is None:
        dense = f.num_arcs > 2000
    if dense:
        d = _shortest_distance_np(f, reverse, sr, max_sweeps)
        if d is not None:
            return d
        raise RuntimeError("shortest_distance: not converging (cycle mass >= 1?)")
    n = f.num_states
    d = [sr.zero] * n
    r = [sr.zero] * n
    adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    if reverse:
        for i in range(f.num_arcs):
            adj[f.arc_dst[i]].append((f.arc_src[i], f.arc_weight[i]))
        sources = [(s, w) for s, w in f.finals.items()]
    else:
        for i in range(f.num_arcs):
            adj[f.arc_src[i]].append((f.arc_dst[i], f.arc_weight[i]))
        sources = [(f.start, sr.one)] if f.start >= 0 else []

    in_q = [False] * n
    dq: deque[int] = deque()
    for s, w in sources:
        d[s] = sr.plus(d[s], w)
        r[s] = sr.plus(r[s], w)
        if not in_q[s]:
            in_q[s] = True
            dq.append(s)
    sweeps = 0
    while dq:
        q = dq.popleft()
        in_q[q] = False
        rq, r[q] = r[q], sr.zero
        sweeps += 1
        if sweeps > max_sweeps * max(n, 1):
            raise RuntimeError("shortest_distance: not converging (negative cycle?)")
        for nxt, w in adj[q]:
            nw = sr.times(rq, w)
            new_d = sr.plus(d[nxt], nw)
            if not sr.approx_equal(d[nxt], new_d, _DELTA):
                d[nxt] = new_d
                r[nxt] = sr.plus(r[nxt], nw)
                if not in_q[nxt]:
                    in_q[nxt] = True
                    dq.append(nxt)
    return d


def shortest_path(f: Fst) -> tuple[float, list[int], list[int]]:
    """Tropical 1-best: returns (cost, ilabels, olabels) (eps excluded)."""
    n = f.num_states
    if f.start < 0 or not f.finals:
        return INF, [], []
    adj = f.out_arcs()
    dist = [INF] * n
    back: list[Optional[int]] = [None] * n
    dist[f.start] = 0.0
    # Bellman-Ford with queue (arcs may have negative weights after pushing)
    in_q = [False] * n
    dq = deque([f.start])
    in_q[f.start] = True
    rounds = 0
    while dq:
        q = dq.popleft()
        in_q[q] = False
        rounds += 1
        if rounds > 100 * max(n, 1) * max(1, len(adj)):
            raise RuntimeError("shortest_path: negative cycle")
        for ai in adj[q]:
            nd = dist[q] + f.arc_weight[ai]
            t = f.arc_dst[ai]
            if nd < dist[t] - 1e-12:
                dist[t] = nd
                back[t] = ai
                if not in_q[t]:
                    in_q[t] = True
                    dq.append(t)
    best_s, best_c = -1, INF
    for s, w in f.finals.items():
        c = dist[s] + w
        if c < best_c:
            best_c, best_s = c, s
    if best_s < 0:
        return INF, [], []
    # trace back; `back` holds the last arc on the best path into each state.
    # Walk arcs backwards from best_s.
    il, ol = [], []
    s = best_s
    guard = 0
    while s != f.start and back[s] is not None:
        ai = back[s]
        if f.arc_ilabel[ai] != EPSILON:
            il.append(f.arc_ilabel[ai])
        if f.arc_olabel[ai] != EPSILON:
            ol.append(f.arc_olabel[ai])
        s = f.arc_src[ai]
        guard += 1
        if guard > f.num_arcs + f.num_states:
            raise RuntimeError("shortest_path: backtrace loop")
    return best_c, il[::-1], ol[::-1]


def string_weight(f: Fst, iseq: list[int], semiring: Optional[Semiring] = None) -> float:
    """⊕-sum of weights of all successful paths with input label seq `iseq`.

    Epsilon input arcs may be taken anywhere. Used for equivalence testing.
    """
    sr = semiring or f.semiring
    if f.start < 0:
        return sr.zero
    adj = f.out_arcs()

    def eps_closure(dist: dict[int, float]) -> dict[int, float]:
        # relax eps arcs to convergence (assumes no divergent eps cycle)
        dq = deque(dist)
        while dq:
            q = dq.popleft()
            for ai in adj[q]:
                if f.arc_ilabel[ai] == EPSILON:
                    w = sr.times(dist[q], f.arc_weight[ai])
                    t = f.arc_dst[ai]
                    nw = sr.plus(dist.get(t, sr.zero), w)
                    if not sr.approx_equal(dist.get(t, sr.zero), nw, 1e-12):
                        dist[t] = nw
                        dq.append(t)
        return dist

    cur = eps_closure({f.start: sr.one})
    for lab in iseq:
        nxt: dict[int, float] = {}
        for q, wq in cur.items():
            for ai in adj[q]:
                if f.arc_ilabel[ai] == lab:
                    t = f.arc_dst[ai]
                    w = sr.times(wq, f.arc_weight[ai])
                    nxt[t] = sr.plus(nxt.get(t, sr.zero), w)
        cur = eps_closure(nxt)
        if not cur:
            return sr.zero
    total = sr.zero
    for q, wq in cur.items():
        fw = f.final_weight(q)
        if fw != INF:
            total = sr.plus(total, sr.times(wq, fw))
    return total


# ---------------------------------------------------------------------------
# Weight pushing
# ---------------------------------------------------------------------------


def push_weights(f: Fst, semiring: Optional[Semiring] = None) -> Fst:
    """Push weights toward the initial state (fstpush --push_weights).

    Potentials are reverse shortest distances; equivalence is preserved by
    re-multiplying the total weight onto the start state's out-arcs/finality
    (reweighting with *any* finite potential preserves path weights, so when
    log-semiring distances diverge — cycles with probability mass >= 1, cf.
    the stochasticity note in `bin/build-wfst-openfst:11-12` of the reference
    — we fall back to tropical potentials).
    """
    sr = semiring or f.semiring
    # the log Jacobi sweep has a geometric convergence tail on cyclic
    # machines; at WSJ-scale CLGs waiting out 10k sweeps costs many
    # minutes, so cap the attempt and fall back to tropical potentials
    # (any finite potential preserves path weights)
    log_sweeps = 400 if f.num_arcs > 500_000 else 10000
    try:
        d = shortest_distance(f, reverse=True, semiring=sr,
                              max_sweeps=log_sweeps if sr.name == "log"
                              else 10000)
    except RuntimeError:
        if sr.name != "log":
            raise
        sr = TROPICAL
        d = shortest_distance(f, reverse=True, semiring=sr)
    import numpy as np

    g = f.copy()
    dv = np.asarray(d, dtype=np.float64)
    src = np.asarray(g.arc_src, dtype=np.int64)
    dst = np.asarray(g.arc_dst, dtype=np.int64)
    w = np.asarray(g.arc_weight, dtype=np.float64)
    fin_s = dv[src] != INF
    fin_t = dv[dst] != INF
    # times/divide are +/- in both semirings
    both = fin_s & fin_t
    w = np.where(both, w + dv[dst] - dv[src], w)
    # restore total weight at the start
    if g.start >= 0 and dv[g.start] != INF:
        tot = dv[g.start]
        w = np.where(src == g.start, w + tot, w)
        if g.start in g.finals:
            g.finals[g.start] = sr.times(g.finals[g.start], tot)
    g.arc_weight = w.tolist()
    for s in list(g.finals):
        if dv[s] != INF:
            g.finals[s] = sr.divide(g.finals[s], float(dv[s]))
    return g


# ---------------------------------------------------------------------------
# Epsilon removal / normalization (gallic: output-string residuals)
# ---------------------------------------------------------------------------


def rmepsilon(f: Fst) -> Fst:
    """Remove arcs with BOTH labels epsilon (OpenFst RmEpsilon semantics)."""
    sr = f.semiring
    adj = f.out_arcs()
    g = Fst(sr)
    g.isyms, g.osyms = f.isyms, f.osyms
    g.num_states = f.num_states
    g.start = f.start

    for q in range(f.num_states):
        # shortest distance within the both-eps subgraph from q
        dist: dict[int, float] = {q: sr.one}
        resid: dict[int, float] = {q: sr.one}
        dq = deque([q])
        while dq:
            s = dq.popleft()
            rs = resid.pop(s, sr.zero)
            if rs == sr.zero:
                continue
            for ai in adj[s]:
                if f.arc_ilabel[ai] == EPSILON and f.arc_olabel[ai] == EPSILON:
                    t = f.arc_dst[ai]
                    w = sr.times(rs, f.arc_weight[ai])
                    nd = sr.plus(dist.get(t, sr.zero), w)
                    if not sr.approx_equal(dist.get(t, sr.zero), nd, _DELTA):
                        dist[t] = nd
                        resid[t] = sr.plus(resid.get(t, sr.zero), w)
                        if t not in dq:
                            dq.append(t)
        fw = sr.zero
        merged: dict[tuple[int, int, int, int], float] = {}
        for r, wd in dist.items():
            rf = f.final_weight(r)
            if rf != INF:
                fw = sr.plus(fw, sr.times(wd, rf))
            for ai in adj[r]:
                if f.arc_ilabel[ai] == EPSILON and f.arc_olabel[ai] == EPSILON:
                    continue
                key = (f.arc_dst[ai], f.arc_ilabel[ai], f.arc_olabel[ai], 0)
                w = sr.times(wd, f.arc_weight[ai])
                merged[key] = sr.plus(merged.get(key, sr.zero), w)
        for (dst, il, ol, _), w in merged.items():
            g.add_arc(q, dst, il, ol, w)
        if fw != sr.zero:
            g.finals[q] = fw
    return connect(g)


def _factor_string(g: Fst, src: int, dst: int, il: int, ostr: tuple, w: float) -> None:
    """Add an arc src->dst with input il, output string ostr, weight w,
    factoring extra output labels into a chain of eps-input arcs."""
    if len(ostr) == 0:
        g.add_arc(src, dst, il, EPSILON, w)
        return
    cur = src
    for k, ol in enumerate(ostr):
        last = k == len(ostr) - 1
        nxt = dst if last else g.add_state()
        g.add_arc(cur, nxt, il if k == 0 else EPSILON, ol, w if k == 0 else g.semiring.one)
        cur = nxt


def epsnormalize_input(f: Fst) -> Fst:
    """Remove input-epsilon arcs, pushing their output strings/weights onto
    following arcs (fstepsnormalize for the input side).

    Output strings accumulated along input-eps paths are re-emitted either
    fused onto the following non-eps arc (first label) plus a factored chain,
    or at final states as eps-input suffix chains.
    """
    sr = f.semiring
    adj = f.out_arcs()
    g = Fst(sr)
    g.isyms, g.osyms = f.isyms, f.osyms
    g.num_states = f.num_states
    g.start = f.start

    for q in range(f.num_states):
        # closure over input-eps arcs: (state, ostr) -> weight
        dist: dict[tuple[int, tuple], float] = {(q, ()): sr.one}
        dq = deque([(q, ())])
        hops = 0
        while dq:
            s, ostr = dq.popleft()
            wd = dist[(s, ostr)]
            hops += 1
            if hops > 10 * (f.num_states + 4) * (f.num_arcs + 4):
                raise RuntimeError("epsnormalize: divergent input-eps cycle")
            for ai in adj[s]:
                if f.arc_ilabel[ai] != EPSILON:
                    continue
                ol = f.arc_olabel[ai]
                nstr = ostr + ((ol,) if ol != EPSILON else ())
                if len(nstr) > f.num_states + 2:
                    raise RuntimeError("epsnormalize: unbounded output string on eps cycle")
                key = (f.arc_dst[ai], nstr)
                w = sr.times(wd, f.arc_weight[ai])
                old = dist.get(key, sr.zero)
                nd = sr.plus(old, w)
                if not sr.approx_equal(old, nd, _DELTA):
                    dist[key] = nd
                    dq.append(key)

        emitted_final: dict[tuple, float] = {}
        merged: dict[tuple[int, int, tuple], float] = {}
        for (r, ostr), wd in dist.items():
            rf = f.final_weight(r)
            if rf != INF:
                w = sr.times(wd, rf)
                emitted_final[ostr] = sr.plus(emitted_final.get(ostr, sr.zero), w)
            for ai in adj[r]:
                if f.arc_ilabel[ai] == EPSILON:
                    continue
                aol = f.arc_olabel[ai]
                nstr = ostr + ((aol,) if aol != EPSILON else ())
                key = (f.arc_dst[ai], f.arc_ilabel[ai], nstr)
                w = sr.times(wd, f.arc_weight[ai])
                merged[key] = sr.plus(merged.get(key, sr.zero), w)
        for (dst, il, ostr), w in merged.items():
            if len(ostr) <= 1:
                g.add_arc(q, dst, il, ostr[0] if ostr else EPSILON, w)
            else:
                mid = g.add_state()
                g.add_arc(q, mid, il, ostr[0], w)
                _factor_string(g, mid, dst, EPSILON, ostr[1:], sr.one)
        for ostr, w in emitted_final.items():
            if not ostr:
                g.finals[q] = sr.plus(g.finals.get(q, sr.zero), w)
            else:
                end = g.add_state()
                _factor_string(g, q, end, EPSILON, ostr, w)
                g.finals[end] = sr.plus(g.finals.get(end, sr.zero), sr.one)
    return connect(g)


# ---------------------------------------------------------------------------
# Determinization (weighted subset construction with gallic residuals)
# ---------------------------------------------------------------------------


def _determinize_native(f: Fst) -> Fst:
    """Native subset construction (`native/jtpu_native.cpp`
    `jtpu_determinize`): the machine `determinize_plain` gives, up to state
    numbering and the order of log sums. Raises when the native library
    cannot be built or loaded."""
    import numpy as np

    from ..native import determinize as native_det

    n = f.num_states
    src = np.asarray(f.arc_src, np.int64)
    order = np.argsort(src, kind="stable")
    counts = np.bincount(src, minlength=n) if len(src) else np.zeros(n, np.int64)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    final_w = np.full(n, INF, np.float64)
    for s, w in f.finals.items():
        final_w[s] = w
    d = native_det(
        n, f.start, row_ptr,
        np.asarray(f.arc_dst, np.int32)[order],
        np.asarray(f.arc_ilabel, np.int32)[order],
        np.asarray(f.arc_olabel, np.int32)[order],
        np.asarray(f.arc_weight, np.float64)[order],
        final_w, f.semiring.name,
    )
    sr = f.semiring
    g = Fst(sr)
    g.isyms, g.osyms = f.isyms, f.osyms
    g.num_states = d["n_states"]
    g.start = 0
    str_off, str_len, str_labels = d["str_off"], d["str_len"], d["str_labels"]

    def ostr(i):
        o, L = int(str_off[i]), int(str_len[i])
        return tuple(int(x) for x in str_labels[o : o + L])

    for a in range(len(d["arc_src"])):
        s, t = int(d["arc_src"][a]), int(d["arc_dst"][a])
        il, w = int(d["arc_il"][a]), float(d["arc_w"][a])
        o = ostr(int(d["arc_ostr"][a]))
        if len(o) <= 1:
            g.add_arc(s, t, il, o[0] if o else EPSILON, w)
        else:
            mid = g.add_state()
            g.add_arc(s, mid, il, o[0], w)
            _factor_string(g, mid, t, EPSILON, o[1:], sr.one)
    for i in range(len(d["fin_sid"])):
        sid, w = int(d["fin_sid"][i]), float(d["fin_w"][i])
        o = ostr(int(d["fin_ostr"][i]))
        if not o:
            g.finals[sid] = sr.plus(g.finals.get(sid, sr.zero), w)
        else:
            end = g.add_state()
            _factor_string(g, sid, end, EPSILON, o, w)
            g.finals[end] = sr.plus(g.finals.get(end, sr.zero), sr.one)
    return g


def determinize(f: Fst) -> Fst:
    """Weighted determinization, by the native subset construction.

    Epsilon is treated as a regular symbol (OpenFst fstdeterminize
    behaviour, relied on by the reference pipeline for G's backoff arcs).
    Transducer outputs are handled with string residuals; leftover strings
    at final states or common prefixes longer than one are factored into
    eps-input chains. Requires the (gallic) twins property to terminate.
    Raises when the native library cannot be built or loaded: the port
    never takes the Python path on its own."""
    if f.start < 0:
        return Fst(f.semiring)
    return _determinize_native(f)


def determinize_plain(f: Fst) -> Fst:
    """The pure-Python subset construction: the plain version of
    `determinize`, which the tests hold the native one to."""
    sr = f.semiring
    if f.start < 0:
        return Fst(sr)
    adj = f.out_arcs()
    g = Fst(sr)
    g.isyms, g.osyms = f.isyms, f.osyms

    # subset: tuple of (state, residual weight, residual out string), sorted
    def canon(subset: list[tuple[int, float, tuple]]):
        return tuple((s, _qw(w), o) for s, w, o in sorted(subset, key=lambda e: (e[0], e[2])))

    smap: dict = {}
    dq: deque = deque()

    def get_state(subset):
        key = canon(subset)
        sid = smap.get(key)
        if sid is None:
            sid = g.add_state()
            smap[key] = sid
            dq.append((key, subset))
        return sid

    start_subset = [(f.start, sr.one, ())]
    g.start = get_state(start_subset)

    while dq:
        key, subset = dq.popleft()
        sid = smap[key]

        # finality: collect (ostr, weight)
        finals: dict[tuple, float] = {}
        for (s, w, ostr) in subset:
            fw = f.final_weight(s)
            if fw != INF:
                tw = sr.times(w, fw)
                finals[ostr] = sr.plus(finals.get(ostr, sr.zero), tw)
        for ostr, w in finals.items():
            if not ostr:
                g.finals[sid] = sr.plus(g.finals.get(sid, sr.zero), w)
            else:
                end = g.add_state()
                _factor_string(g, sid, end, EPSILON, ostr, w)
                g.finals[end] = sr.plus(g.finals.get(end, sr.zero), sr.one)

        # group outgoing arcs by input label
        by_label: dict[int, dict[tuple[int, tuple], float]] = defaultdict(dict)
        for (s, w, ostr) in subset:
            for ai in adj[s]:
                il = f.arc_ilabel[ai]
                ol = f.arc_olabel[ai]
                nstr = ostr + ((ol,) if ol != EPSILON else ())
                dkey = (f.arc_dst[ai], nstr)
                nw = sr.times(w, f.arc_weight[ai])
                cur = by_label[il].get(dkey, sr.zero)
                by_label[il][dkey] = sr.plus(cur, nw)

        for il, cands in by_label.items():
            entries = list(cands.items())
            # arc weight: ⊕ of all candidate weights
            total = sr.zero
            for _, w in entries:
                total = sr.plus(total, w)
            # common output prefix across all candidates
            strs = [dkey[1] for dkey, _ in entries]
            prefix = strs[0]
            for st in strs[1:]:
                k = 0
                while k < len(prefix) and k < len(st) and prefix[k] == st[k]:
                    k += 1
                prefix = prefix[:k]
                if not prefix:
                    break
            new_subset = [
                (dkey[0], sr.divide(w, total), dkey[1][len(prefix):])
                for dkey, w in entries
            ]
            nsid = get_state(new_subset)
            if len(prefix) <= 1:
                g.add_arc(sid, nsid, il, prefix[0] if prefix else EPSILON, total)
            else:
                mid = g.add_state()
                g.add_arc(sid, mid, il, prefix[0], total)
                _factor_string(g, mid, nsid, EPSILON, prefix[1:], sr.one)

        if len(smap) > 50_000_000:
            raise RuntimeError("determinize: subset blow-up (not determinizable?)")
    return g


# ---------------------------------------------------------------------------
# Minimization (weighted, deterministic input)
# ---------------------------------------------------------------------------


def _minimize_refine_np(f: Fst, arc_code, block):
    """Vectorized Moore partition refinement: each round lexsorts the arc
    table and hashes every state's SORTED outgoing (label-code, qweight,
    dst-block) multiset in one numpy pass (the pure-Python round is
    O(states x degree x log) with large constants; at a 1000-word LG this
    was ~29 s vs <1 s here)."""
    import numpy as np

    n = f.num_states
    src = np.asarray(f.arc_src, np.int64)
    dst = np.asarray(f.arc_dst, np.int64)
    code = np.asarray(arc_code, np.int64)
    qw = np.asarray([_qw(w) for w in f.arc_weight], np.int64)
    blk = np.empty(n, np.int64)
    for s, b in block.items():
        blk[s] = b
    nblocks = int(blk.max(initial=-1)) + 1
    # two 31-bit prime moduli: products of residues stay well inside int64
    M1, M2 = (1 << 31) - 1, 2147483629
    P1, P2 = 1_000_003, 9_176_941
    while True:
        db = blk[dst]
        order = np.lexsort((db, qw, code, src))
        so = src[order]
        ao = (
            ((code[order] % M1) * 1_000_003 % M1 + qw[order] % M1) * 31
            + db[order]
        ) % M1
        sh1 = np.zeros(n, np.int64)
        sh2 = np.zeros(n, np.int64)
        if len(so):
            # within-src rank -> position-dependent polynomial hash of the
            # canonically sorted arc multiset
            boundaries = np.empty(len(so), bool)
            boundaries[0] = True
            boundaries[1:] = so[1:] != so[:-1]
            seg_start = np.maximum.accumulate(
                np.where(boundaries, np.arange(len(so)), 0)
            )
            rank = np.arange(len(so)) - seg_start
            # P^rank mod M via square-and-multiply on the rank bits
            e1 = np.ones(len(so), np.int64)
            e2 = np.ones(len(so), np.int64)
            r = rank.copy()
            bb1, bb2 = P1 % M1, P2 % M2
            maxr = int(rank.max(initial=0))
            while maxr > 0:
                odd = (r & 1) == 1
                e1[odd] = (e1[odd] * bb1) % M1
                e2[odd] = (e2[odd] * bb2) % M2
                r >>= 1
                bb1 = (bb1 * bb1) % M1
                bb2 = (bb2 * bb2) % M2
                maxr >>= 1
            t1 = ((ao + 1) * e1) % M1
            t2 = ((ao % M2 + 1) * e2) % M2
            np.add.at(sh1, so, t1)
            np.add.at(sh2, so, t2)
            sh1 %= M1
            sh2 %= M2
        sig = np.stack([blk, sh1, sh2], axis=1)
        _, new_blk = np.unique(sig, axis=0, return_inverse=True)
        new_n = int(new_blk.max(initial=-1)) + 1
        if new_n == nblocks:
            # Exact-signature verification (one vectorized pass): the
            # refinement above replaces arc multisets with two modular
            # polynomial hashes; a collision would silently merge
            # inequivalent states. Check that all states in a block have
            # identical SORTED (code, qweight, dst-block) arc sequences;
            # on mismatch, split at the first differing rank and keep
            # refining (astronomically rare, but now impossible to miss).
            deg = np.bincount(src, minlength=n)
            bad = False
            # degree must be constant per block
            for arr in (deg,):
                o = np.argsort(blk, kind="stable")
                b_sorted = blk[o]
                v = arr[o]
                nb = np.empty(len(o), bool)
                nb[0] = False
                nb[1:] = b_sorted[1:] == b_sorted[:-1]
                if np.any(nb & (v != np.concatenate([[0], v[:-1]]))):
                    bad = True
            if not bad and len(src):
                db = blk[dst]
                order = np.lexsort((db, qw, code, src))
                so = src[order]
                boundaries = np.empty(len(so), bool)
                boundaries[0] = True
                boundaries[1:] = so[1:] != so[:-1]
                seg_start = np.maximum.accumulate(
                    np.where(boundaries, np.arange(len(so)), 0)
                )
                rank = np.arange(len(so)) - seg_start
                key_rows = np.stack(
                    [blk[so], rank, code[order], qw[order], db[order]], axis=1
                )
                o2 = np.lexsort(key_rows[:, ::-1].T)
                kr = key_rows[o2]
                same_group = np.all(kr[1:, :2] == kr[:-1, :2], axis=1)
                mismatch = same_group & np.any(
                    kr[1:, 2:] != kr[:-1, 2:], axis=1
                )
                if np.any(mismatch):
                    bad = True
                    # split by the full triple at the first bad rank
                    i = int(np.nonzero(mismatch)[0][0])
                    bad_blk, bad_rank = int(kr[i, 0]), int(kr[i, 1])
                    sel = (blk[so] == bad_blk) & (rank == bad_rank)
                    split_key = np.zeros(n, np.int64)
                    split_key[so[sel]] = (
                        (code[order][sel] * 1315423911 + qw[order][sel]) * 31
                        + db[order][sel]
                    )
                    sig2 = np.stack([blk, split_key], axis=1)
                    _, new_blk = np.unique(sig2, axis=0, return_inverse=True)
                    nblocks = int(new_blk.max(initial=-1)) + 1
                    blk = new_blk.astype(np.int64)
                    continue
            if not bad:
                break
            # degree anomaly: fall back to splitting on degree
            sig2 = np.stack([blk, deg], axis=1)
            _, new_blk = np.unique(sig2, axis=0, return_inverse=True)
            if int(new_blk.max(initial=-1)) + 1 == nblocks:
                break
            nblocks = int(new_blk.max(initial=-1)) + 1
            blk = new_blk.astype(np.int64)
            continue
        nblocks = new_n
        blk = new_blk.astype(np.int64)
    return {s: int(blk[s]) for s in range(n)}


def minimize(f: Fst) -> Fst:
    """Minimize a deterministic machine.

    Equivalent to the reference pipeline's
    encode_labels -> fstminimize -> decode: label pairs are treated as
    atomic symbols, weights are pushed to the initial state, then classic
    partition refinement (Moore) merges equivalent states.
    """
    f = connect(f)
    if f.num_states == 0:
        return f
    # canonicalize weights with TROPICAL potentials: equivalent states have
    # equal min-suffix-distance, so the pushed residuals are canonical and
    # the refinement partition is exactly the one log pushing yields — but
    # tropical Jacobi converges in <= diameter sweeps while log pushing has
    # a geometric tail on cyclic machines. Pushing is
    # BEST-EFFORT: the reference's `fstencode --encode_labels | fstminimize`
    # (`bin/build-wfst-openfst:118-120`) freezes weights into labels and
    # never pushes at all, so machines where distances diverge (e.g. the
    # -log2 aux self-loop cycles det() creates from cdgen's duplicated aux
    # arcs) are minimized unpushed — weights already participate in the
    # refinement signature.
    try:
        f = push_weights(f, semiring=TROPICAL)
    except RuntimeError:
        pass
    n = f.num_states
    adj = f.out_arcs()

    # encode (il, ol) -> atomic symbol
    enc: dict[tuple[int, int], int] = {}

    def code(il, ol):
        k = (il, ol)
        v = enc.get(k)
        if v is None:
            v = len(enc)
            enc[k] = v
        return v

    arc_code = [code(f.arc_ilabel[i], f.arc_olabel[i]) for i in range(f.num_arcs)]

    # initial partition by finality (quantized weight)
    def fkey(s):
        w = f.final_weight(s)
        return _qw(w) if w != INF else -1

    block = {}
    groups: dict = defaultdict(list)
    for s in range(n):
        groups[fkey(s)].append(s)
    for bid, (k, members) in enumerate(groups.items()):
        for s in members:
            block[s] = bid
    nblocks = len(groups)

    if f.num_arcs > 2000:
        block = _minimize_refine_np(f, arc_code, block)
    else:
        while True:
            sig = {}
            for s in range(n):
                items = sorted(
                    (arc_code[ai], _qw(f.arc_weight[ai]), block[f.arc_dst[ai]])
                    for ai in adj[s]
                )
                sig[s] = (block[s], tuple(items))
            groups = defaultdict(list)
            for s in range(n):
                groups[sig[s]].append(s)
            if len(groups) == nblocks:
                break
            nblocks = len(groups)
            for bid, members in enumerate(groups.values()):
                for s in members:
                    block[s] = bid

    # rebuild with one state per block
    rep: dict[int, int] = {}
    g = Fst(f.semiring)
    g.isyms, g.osyms = f.isyms, f.osyms
    for s in range(n):
        b = block[s]
        if b not in rep:
            rep[b] = g.add_state()
    g.start = rep[block[f.start]]
    seen_arcs = set()
    for s in range(n):
        b = rep[block[s]]
        if f.is_final(s):
            g.finals[b] = f.final_weight(s)
        for ai in adj[s]:
            t = rep[block[f.arc_dst[ai]]]
            key = (b, t, arc_code[ai], _qw(f.arc_weight[ai]))
            if key in seen_arcs:
                continue
            seen_arcs.add(key)
            g.add_arc(b, t, f.arc_ilabel[ai], f.arc_olabel[ai], f.arc_weight[ai])
    return connect(g)


# ---------------------------------------------------------------------------
# Random generation (WFSTNetwork::generateSequences analogue)
# ---------------------------------------------------------------------------


def generate_sequences(f: Fst, n: int = 10, max_len: int = 1000, seed: Optional[int] = None
                       ) -> list[tuple[list[int], list[int], float]]:
    """Random accepted paths: (ilabels, olabels, cost) triples (eps dropped),
    with the JAX function's `random.Random(seed)` draws, so a seed gives
    the same sequences (`WFSTNetwork::generateSequences` analogue)."""
    rng = random.Random(seed)
    if f.start < 0 or f.num_states == 0:
        return []
    adj = f.out_arcs()
    out = []
    for _ in range(n):
        s = f.start
        il: list[int] = []
        ol: list[int] = []
        cost = 0.0
        for _ in range(max_len):
            opts = adj[s]
            if f.is_final(s) and (not opts or rng.random() < 0.1):
                out.append((il, ol, cost + f.final_weight(s)))
                break
            if not opts:
                break  # dead end, discard
            ai = opts[rng.randrange(len(opts))]
            if f.arc_ilabel[ai] != EPSILON:
                il.append(int(f.arc_ilabel[ai]))
            if f.arc_olabel[ai] != EPSILON:
                ol.append(int(f.arc_olabel[ai]))
            cost += float(f.arc_weight[ai])
            s = int(f.arc_dst[ai])
    return out
