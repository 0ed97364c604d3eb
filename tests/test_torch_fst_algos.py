"""The port's FST algorithms (`juicer_tpu_torch.fst.algos`) against the JAX
package's (`juicer_tpu.fst.algos`), on the CPU.

The same machines, made from a seed with numpy (`default_rng`; LOG and
TROPICAL; epsilon labels on either side), go through both packages'
functions. The results must be equal state for state and arc for arc:
start, state count, finals, and every arc's source, destination, labels
and weight in order. Weights are compared exactly, log sums included:
both packages add the same float64 terms in the same order, which is
what keeps the tracked networks' bits (`test_torch_compile.py`).

  - every algorithm of `algos.py` on random machines: arcsort, invert,
    project, closure, concat, union, connect, compose (with and without
    connecting), rmepsilon, epsnormalize_input, determinize, minimize
    (both refinements: the Python one below 2,000 arcs and the numpy one
    above), shortest_distance (the queue and the Jacobi sweep, forward
    and reverse), push_weights, string_weight, shortest_path,
    generate_sequences, `_qw`;
  - the native `determinize` equals the port's pure-Python
    `determinize_plain`, the JAX native path and the JAX Python path;
    without the native library the port's `determinize` raises;
  - the cases of `tests/test_fst.py`, mirrored: each builds its machines
    in both packages, checks the port's result as that file checks the
    JAX one, and holds it to the JAX result.
"""

import io
import math

import numpy as np
import pytest
import torch

from juicer_tpu import fst as jfst
from juicer_tpu.fst import algos as jalgos

from juicer_tpu_torch import fst as tfst
from juicer_tpu_torch import native
from juicer_tpu_torch.fst import algos
from juicer_tpu_torch.fst.semiring import INF


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread, as in the other port test files (the suite's
    workers share the machine's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_fst(got, want):
    """State for state and arc for arc, weights exactly."""
    assert (got.num_states, got.start) == (want.num_states, want.start)
    assert dict(got.finals) == dict(want.finals)
    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
        assert list(getattr(got, k)) == list(getattr(want, k)), k
    assert got.semiring.name == want.semiring.name


def spec(seed, n_states=8, n_arcs=20, n_labels=4, eps=0.25, acyclic=False, w=(0.5, 3.0),
         n_finals=2):
    """A random machine as plain lists: (arcs, finals). Acyclic machines
    only go forward; labels are epsilon with probability `eps`."""
    rng = np.random.default_rng(seed)
    arcs = []
    for _ in range(n_arcs):
        s = int(rng.integers(n_states - 1 if acyclic else n_states))
        t = int(rng.integers(s + 1, n_states)) if acyclic else int(rng.integers(n_states))
        il = 0 if rng.random() < eps else int(rng.integers(1, n_labels + 1))
        ol = 0 if rng.random() < eps else int(rng.integers(1, n_labels + 1))
        arcs.append((s, t, il, ol, float(rng.uniform(*w))))
    finals = {n_states - 1: float(rng.uniform(0, 1))}
    for s in rng.choice(n_states, n_finals - 1, replace=False).tolist():
        finals.setdefault(int(s), float(rng.uniform(0, 1)))
    return arcs, finals


def deterministic_spec(seed, n_states, n_labels=10, w=(0.0, 1.0, 2.0)):
    """A random deterministic acceptor-like transducer (distinct input
    labels out of each state) with weights from a small set, so that
    minimization has states to merge."""
    rng = np.random.default_rng(seed)
    arcs = []
    for s in range(n_states):
        labels = rng.choice(n_labels, int(rng.integers(1, n_labels)), replace=False) + 1
        for il in labels.tolist():
            t = int(rng.integers(n_states))
            arcs.append((s, t, il, int(il % 3), float(rng.choice(w))))
    finals = {int(s): float(rng.choice(w)) for s in rng.choice(n_states, n_states // 4,
                                                                  replace=False)}
    return arcs, finals


def build(pkg, sp, sr_name, start=0):
    arcs, finals = sp
    f = pkg.Fst(getattr(pkg, sr_name))
    f.set_start(start)
    for a in arcs:
        f.add_arc(*a)
    for s, w in finals.items():
        f.set_final(s, w)
    return f


def both(sp, sr_name):
    return build(jfst, sp, sr_name), build(tfst, sp, sr_name)


SRS = ["LOG", "TROPICAL"]
SEEDS = [0, 1, 2]
# name -> (op on a machine, spec keyword arguments)
UNARY = {
    "arcsort_ilabel": (lambda A, f: A.arcsort(f), {}),
    "arcsort_olabel": (lambda A, f: A.arcsort(f, by="olabel"), {}),
    "invert": (lambda A, f: A.invert(f), {}),
    "project_input": (lambda A, f: A.project(f), {}),
    "project_output": (lambda A, f: A.project(f, output=True), {}),
    "closure": (lambda A, f: A.closure(f), {}),
    "connect": (lambda A, f: A.connect(f), {"n_arcs": 10}),
    "rmepsilon": (lambda A, f: A.rmepsilon(f), {"eps": 0.5, "w": (1.5, 3.0)}),
    "epsnormalize_input": (lambda A, f: A.epsnormalize_input(f), {"eps": 0.4, "acyclic": True}),
    "determinize": (lambda A, f: A.determinize(f), {"acyclic": True, "eps": 0.2}),
    "determinize_minimize": (lambda A, f: A.minimize(A.determinize(f)),
                             {"acyclic": True, "eps": 0.2, "n_states": 10, "n_arcs": 30}),
    "push_weights": (lambda A, f: A.push_weights(f), {"w": (1.5, 3.0)}),
    "push_weights_dense": (lambda A, f: A.push_weights(f), {"n_states": 600, "n_arcs": 2400,
                                                            "w": (1.5, 3.0), "n_finals": 40}),
}


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sr", SRS)
@pytest.mark.parametrize("op", list(UNARY))
def test_unary_algorithm_equals_jax(op, sr, seed):
    fn, kw = UNARY[op]
    jf, tf = both(spec(seed, **kw), sr)
    want, got = fn(jalgos, jf), fn(algos, tf)
    assert_same_fst(got, want)
    if op.startswith("determinize"):
        assert got.num_arcs > 0


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("sr", SRS)
@pytest.mark.parametrize("op", ["compose", "compose_unconnected", "concat", "union"])
def test_binary_algorithm_equals_jax(op, sr, seed):
    ja, ta = both(spec(seed, eps=0.3), sr)
    jb, tb = both(spec(seed + 100, n_states=5, n_arcs=14, eps=0.3), sr)
    fn = {"compose": lambda A, a, b: A.compose(a, b),
          "compose_unconnected": lambda A, a, b: A.compose(a, b, connect_result=False),
          "concat": lambda A, a, b: A.concat(a, b),
          "union": lambda A, a, b: A.union(a, b)}[op]
    assert_same_fst(fn(algos, ta, tb), fn(jalgos, ja, jb))


@pytest.mark.parametrize("n_states", [40, 600])
@pytest.mark.parametrize("seed", SEEDS)
def test_minimize_equals_jax(seed, n_states):
    """Both partition refinements: Python below 2,000 arcs, numpy above."""
    jf, tf = both(deterministic_spec(seed, n_states), "TROPICAL")
    got = algos.minimize(tf)
    assert_same_fst(got, jalgos.minimize(jf))
    assert (tf.num_arcs > 2000) == (n_states == 600)
    assert got.num_states <= tf.num_states


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("sr", SRS)
def test_shortest_distance_equals_jax(sr, reverse, dense):
    jf, tf = both(spec(5, n_states=30, n_arcs=80, w=(1.5, 3.0)), sr)
    got = algos.shortest_distance(tf, reverse=reverse, dense=dense)
    assert got == jalgos.shortest_distance(jf, reverse=reverse, dense=dense)
    assert any(d != INF for d in got)


@pytest.mark.parametrize("sr", SRS)
def test_paths_and_string_weights_equal_jax(sr):
    jf, tf = both(spec(7, n_states=10, n_arcs=30, eps=0.2, w=(1.5, 3.0)), sr)
    assert algos.shortest_path(tf) == jalgos.shortest_path(jf)
    assert algos.generate_sequences(tf, 20, seed=3) == jalgos.generate_sequences(jf, 20, seed=3)
    # string weights on an acyclic machine: `string_weight` relaxes input
    # epsilons to convergence, which a random epsilon cycle need not reach
    jf, tf = both(spec(7, n_states=12, n_arcs=40, eps=0.2, acyclic=True, w=(1.5, 3.0)), sr)
    seqs = algos.generate_sequences(tf, 20, seed=3)
    assert seqs == jalgos.generate_sequences(jf, 20, seed=3)
    assert seqs
    for il, _, _ in seqs:
        assert algos.string_weight(tf, il) == jalgos.string_weight(jf, il)
    assert algos._KEY_DELTA == jalgos._KEY_DELTA
    for w in (0.0, 1.2345678, -3.5e-7, INF, 1e6):
        assert algos._qw(w) == jalgos._qw(w)


def canonical(f):
    """A machine renumbered in breadth-first order from the start, each
    state's arcs taken by (ilabel, olabel, weight to 1e-6): (states,
    sorted arcs, sorted finals). Two machines that differ only in state
    numbering and arc order give the same form, up to the weights' last
    bits."""
    adj = f.out_arcs()
    key = lambda i: (f.arc_ilabel[i], f.arc_olabel[i], round(f.arc_weight[i], 6))
    new = {f.start: 0}
    order = [f.start]
    for s in order:
        for i in sorted(adj[s], key=key):
            if f.arc_dst[i] not in new:
                new[f.arc_dst[i]] = len(order)
                order.append(f.arc_dst[i])
    arcs = sorted((new[f.arc_src[i]], new[f.arc_dst[i]], f.arc_ilabel[i], f.arc_olabel[i],
                   f.arc_weight[i]) for i in range(f.num_arcs))
    return len(order), arcs, sorted((new[s], w) for s, w in f.finals.items())


# native and plain add a state's log sums in other orders (the native one
# sorts the candidates by label and destination first)
DET_TOL = 1e-12


def assert_same_up_to_numbering(got, want):
    (n, arcs, fins), (n2, arcs2, fins2) = canonical(got), canonical(want)
    assert n == n2 == got.num_states == want.num_states
    assert [a[:4] for a in arcs] == [a[:4] for a in arcs2]
    assert [s for s, _ in fins] == [s for s, _ in fins2]
    np.testing.assert_allclose([a[4] for a in arcs], [a[4] for a in arcs2], rtol=0, atol=DET_TOL)
    np.testing.assert_allclose([w for _, w in fins], [w for _, w in fins2], rtol=0, atol=DET_TOL)


@pytest.mark.parametrize("seed", SEEDS + [3, 4])
@pytest.mark.parametrize("sr", SRS)
def test_native_determinize_equals_plain_and_jax(sr, seed, monkeypatch):
    """The native subset construction equals the JAX native one arc for
    arc, and the port's plain version the JAX Python path. Native and
    plain visit labels in other orders (the native one sorts them), so
    those two are held equal up to state numbering and arc order, weights
    within DET_TOL."""
    jf, tf = both(spec(seed, n_states=9, n_arcs=24, acyclic=True, eps=0.2), sr)
    got, plain = algos.determinize(tf), algos.determinize_plain(tf)
    assert got.num_arcs > 0
    assert_same_fst(got, jalgos.determinize(jf))
    assert_same_up_to_numbering(got, plain)
    # the JAX package's Python path: its native dispatch switched off
    monkeypatch.setattr(jalgos, "_determinize_native", lambda f: None)
    assert_same_fst(plain, jalgos.determinize(jf))


def test_determinize_raises_without_the_native_library(monkeypatch, tmp_path):
    """No pure-Python fallback: a library that cannot be built raises."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SRC", str(tmp_path / "missing.cpp"))
    f = build(tfst, spec(0, acyclic=True), "LOG")
    with pytest.raises(RuntimeError, match="native source missing"):
        algos.determinize(f)
    # the plain version stays reachable for the tests
    assert algos.determinize_plain(f).num_arcs > 0


# ---------------------------------------------------------------------------
# The cases of tests/test_fst.py, in both packages
# ---------------------------------------------------------------------------


def linear_fst(P, labels, weight_each=1.0, sr=None):
    f = P.Fst(sr or P.TROPICAL)
    s = f.add_state()
    f.set_start(s)
    for lab in labels:
        t = f.add_state()
        f.add_arc(s, t, lab, lab, weight_each)
        s = t
    f.set_final(s, 0.5)
    return f


def machine(P, sr, n, arcs, finals, start=0):
    f = P.Fst(getattr(P, sr))
    for _ in range(n):
        f.add_state()
    f.set_start(start)
    for a in arcs:
        f.add_arc(*a)
    for s, w in finals.items():
        f.set_final(s, w)
    return f


def case_shortest_path(P, A):
    choice = machine(P, "TROPICAL", 2, [(0, 1, 1, 1, 2.0), (0, 1, 2, 2, 1.0)], {1: 0.0})
    r = [A.shortest_path(linear_fst(P, [1, 2, 3])), A.shortest_path(choice)]
    assert r[0][1] == [1, 2, 3] and abs(r[0][0] - 3.5) < 1e-9
    assert r[1][1] == [2] and abs(r[1][0] - 1.0) < 1e-9
    return r


def case_connect(P, A):
    f = machine(P, "TROPICAL", 4, [(0, 1, 1, 1, 0.0), (0, 2, 2, 2, 0.0), (3, 1, 3, 3, 0.0)],
                {1: 0.0})
    g = A.connect(f)
    assert (g.num_states, g.num_arcs) == (2, 1)
    return [g]


def case_invert_project(P, A):
    f = linear_fst(P, [1, 2])
    f.arc_olabel = [5, 6]
    g, h = A.invert(f), A.project(f, output=True)
    assert (g.arc_ilabel, g.arc_olabel, h.arc_ilabel) == ([5, 6], [1, 2], [5, 6])
    return [g, h]


def case_closure(P, A):
    g = A.closure(linear_fst(P, [1], weight_each=2.0))
    ws = [A.string_weight(g, s, P.TROPICAL) for s in ([], [1], [1, 1], [2])]
    assert ws[0] == 0.0 and abs(ws[1] - 2.5) < 1e-9 and abs(ws[2] - 5.0) < 1e-9
    assert ws[3] == INF
    return [g, ws]


def case_compose_simple(P, A):
    b = machine(P, "TROPICAL", 3, [(0, 1, 1, 10, 0.5), (1, 2, 2, 20, 0.5)], {2: 0.0})
    c = A.compose(linear_fst(P, [1, 2]), b)
    cost, il, ol = A.shortest_path(c)
    assert (il, ol) == ([1, 2], [10, 20]) and abs(cost - 3.5) < 1e-9
    return [c]


def case_compose_eps_filter(P, A):
    a = machine(P, "LOG", 3, [(0, 1, 1, 1, 1.0), (1, 2, 2, 0, 1.0)], {2: 0.0})
    b = machine(P, "LOG", 3, [(0, 1, 1, 1, 1.0), (1, 2, 0, 3, 1.0)], {1: 0.0, 2: 0.0})
    c = A.compose(a, b)
    w = A.string_weight(c, [1, 2], P.LOG)
    assert P.LOG.approx_equal(w, P.LOG.plus(3.0, 4.0), 1e-6)
    return [c, w]


def case_compose_random(P, A):
    import random

    rng = random.Random(3)
    out = []
    for trial in range(5):
        a = machine(P, "LOG", 4, [], {3: 0.1})
        for _ in range(8):
            a.add_arc(rng.randrange(4), rng.randrange(4), rng.randrange(1, 3),
                      rng.randrange(0, 3), rng.random())
        b = machine(P, "LOG", 3, [], {2: 0.2})
        for _ in range(6):
            b.add_arc(rng.randrange(3), rng.randrange(3), rng.randrange(0, 3),
                      rng.randrange(1, 3), rng.random())
        c = A.compose(a, b)
        out += [c, [(il, A.string_weight(c, il, P.LOG))
                    for il, _, _ in A.generate_sequences(c, 10, seed=trial)]]
    return out


def case_determinize_acceptor(P, A):
    f = machine(P, "TROPICAL", 4, [(0, 1, 1, 1, 1.0), (0, 2, 1, 1, 2.0), (1, 3, 2, 2, 3.0),
                                   (2, 3, 2, 2, 1.0)], {3: 0.0})
    g = A.determinize(f)
    keys = [(g.arc_src[i], g.arc_ilabel[i]) for i in range(g.num_arcs)]
    assert len(keys) == len(set(keys))
    assert A.string_weight(g, [1, 2]) == A.string_weight(f, [1, 2]) == 3.0
    return [g]


def case_determinize_log_sums(P, A):
    f = machine(P, "LOG", 3, [(0, 1, 1, 1, 1.0), (0, 2, 1, 1, 1.0)], {1: 0.0, 2: 0.0})
    g = A.determinize(f)
    w = A.string_weight(g, [1], P.LOG)
    assert P.LOG.approx_equal(w, 1.0 - math.log(2.0), 1e-6)
    return [g, w]


def case_determinize_residuals(P, A):
    f = machine(P, "TROPICAL", 4, [(0, 1, 1, 10, 1.0), (0, 2, 1, 20, 1.0), (1, 3, 2, 11, 0.0),
                                   (2, 3, 3, 21, 0.0)], {3: 0.0})
    g = A.determinize(f)
    outs = [A.shortest_path(A.compose(A.project(linear_fst(P, s, 0.0)), g))[2]
            for s in ([1, 2], [1, 3])]
    assert outs == [[10, 11], [20, 21]]
    return [g, outs]


def case_minimize(P, A):
    out = []
    for w in ((0.0, 0.0, 0.0, 0.0), (1.0, 2.0, 2.0, 1.0)):
        f = machine(P, "TROPICAL", 5, [(0, 1, 1, 1, w[0]), (1, 2, 3, 3, w[1]),
                                       (0, 3, 2, 2, w[2]), (3, 4, 3, 3, w[3])],
                    {2: 0.0, 4: 0.0})
        g = A.minimize(f)
        assert g.num_states == 3
        assert A.string_weight(g, [1, 3]) == A.string_weight(f, [1, 3])
        out.append(g)
    return out


def case_rmepsilon(P, A):
    f = machine(P, "TROPICAL", 3, [(0, 1, 0, 0, 1.0), (1, 2, 1, 1, 1.0)], {2: 0.5})
    g = A.rmepsilon(f)
    assert all(not (g.arc_ilabel[i] == 0 and g.arc_olabel[i] == 0) for i in range(g.num_arcs))
    assert abs(A.string_weight(g, [1]) - 2.5) < 1e-9
    return [g]


def case_epsnormalize(P, A):
    f = machine(P, "TROPICAL", 3, [(0, 1, 0, 7, 1.0), (1, 2, 1, 8, 1.0)], {2: 0.0})
    g = A.epsnormalize_input(f)
    cost, _, ol = A.shortest_path(A.compose(A.project(linear_fst(P, [1], 0.0)), g))
    assert ol == [7, 8] and abs(cost - 2.5) < 1e-9
    return [g]


def case_push_weights(P, A):
    f = machine(P, "TROPICAL", 3, [(0, 1, 1, 1, 0.0), (1, 2, 2, 2, 5.0), (0, 2, 3, 3, 2.0)],
                {2: 1.0})
    g = A.push_weights(f)
    w1 = [g.arc_weight[i] for i in range(g.num_arcs) if g.arc_ilabel[i] == 1][0]
    assert abs(w1 - 6.0) < 1e-6
    assert A.string_weight(g, [3]) == A.string_weight(f, [3])
    return [g]


def case_det_min_pipeline(P, A):
    m = None
    for w in ([1, 2, 3], [1, 2, 4], [5, 2, 3]):
        f = linear_fst(P, w, 1.0)
        m = f if m is None else A.union(m, f)
    d = A.determinize(A.rmepsilon(m))
    g = A.minimize(d)
    assert all(A.string_weight(g, w) != INF for w in ([1, 2, 3], [1, 2, 4], [5, 2, 3]))
    assert A.string_weight(g, [1, 2]) == INF and g.num_states <= d.num_states
    return [m, d, g]


def case_fsm_io(P, A):
    f = machine(P, "LOG", 3, [(0, 1, 1, 2, 0.25), (1, 2, 3, 0, 0.0), (1, 1, 2, 2, 1.5)],
                {2: 0.75})
    e = P.Fst(P.LOG)
    e.ensure_state(5)
    e.set_start(3)
    e.add_arc(0, 1, 1, 1, 0.0)
    e.add_arc(3, 0, 2, 2, 0.0)
    e.set_final(1)
    out = []
    for m in (f, e):
        buf = io.StringIO()
        P.write_fsm(m, buf)
        out.append(buf.getvalue())
        buf.seek(0)
        out.append(P.read_fsm(buf, P.LOG))
    assert out[1].start == 0 and out[3].start == 3 and out[1].finals[2] == 0.75
    t = P.SymbolTable.with_epsilon()
    t.add("a")
    t.add("#1")
    buf = io.StringIO()
    P.write_symbols(t, buf)
    buf.seek(0)
    t2 = P.read_symbols(buf)
    assert (t2.find("a"), t2.find("#1"), t2.num_aux, "a" in t2) == (1, 2, 1, True)
    return out + [buf.getvalue(), list(t2)]


FST_CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def _same(got, want):
    if isinstance(want, jfst.Fst):
        assert_same_fst(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("case", list(FST_CASES))
def test_fst_case_equals_jax(case):
    got = FST_CASES[case](tfst, algos)
    want = FST_CASES[case](jfst, jalgos)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)
