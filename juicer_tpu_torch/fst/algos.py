"""The FST algorithms the decode path needs, as in `juicer_tpu/fst/algos.py`:
for lattices `connect` (trim to accessible and coaccessible states),
`project` and the tropical `shortest_path`; for the decoder CLI's
`-genTestSeqs`, `generate_sequences`."""

from __future__ import annotations

import random
from collections import deque
from typing import Optional

from .fst import EPSILON, Fst
from .semiring import INF


def project(f: Fst, output: bool = False) -> Fst:
    g = f.copy()
    if output:
        g.arc_ilabel = list(g.arc_olabel)
    else:
        g.arc_olabel = list(g.arc_ilabel)
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


def shortest_path(f: Fst) -> tuple[float, list[int], list[int]]:
    """Tropical 1-best: returns (cost, ilabels, olabels) (eps excluded)."""
    n = f.num_states
    if f.start < 0 or not f.finals:
        return INF, [], []
    adj = f.out_arcs()
    dist = [INF] * n
    back: list[Optional[int]] = [None] * n
    dist[f.start] = 0.0
    # Bellman-Ford with a queue (arcs may have negative weights)
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
    # walk the last arc on the best path into each state back from best_s
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
