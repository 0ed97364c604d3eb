"""HTK regression-class MLLR adaptation (model-space transforms).

The counterpart of `juicer_tpu/am/regtree.py`, the rebuild of the HTKLib
HAdapt regression-class machinery the reference reaches through
`HModels` (`HModels.h:14-120`): a `~b` base-class file assigns Gaussian
components to numbered classes by HTK item lists, a `~r` regression tree
arranges the classes in a tree (parsed; applying a saved transform set
needs only the base classes), and a transform file holds an `<XFORMSET>`
of `<NUMXFORMS>` linear transforms and an `<XFORMWGTSET>` giving each
base class its transform.

MLLRMEAN (HTKBook 9): each Gaussian mean of class c becomes
mu' = A_c mu + b_c; a component of class 0 (no base class matches) or of
a class without a transform keeps its mean. MLLRVAR and global
MLLRCOV / SEMIT are `apply_mllr_var` and `apply_mllr_cov`.

The parsers are host code. The transforms run in float64 on the caller's
device: the components of every GMM are stacked into one (N, D) matrix
and each class is one product over its rows (`transform_rows`); the
adapted parameters come back to the host model set, from which the GMM
scorer is rebuilt (`make_gmm_scorer(models.flat_params())`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from fnmatch import fnmatchcase
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from .xform import _TOKEN_RE, InputXform

# HTK item lists: {(ax,eh-b+d).state[2-4].mix[1-12]}, {*.state[2].mix[1]}
_ITEM_RE = re.compile(
    r"^(?:\((?P<names>[^)]*)\)|(?P<name>[^.{}()]+))"
    r"\.state\[(?P<state>[^\]]+)\]"
    r"(?:\.stream\[(?P<stream>[^\]]+)\])?"
    r"(?:\.mix\[(?P<mix>[^\]]+)\])?$"
)


def _parse_index_spec(spec: str) -> list[tuple[int, int]]:
    """"1,3,5-7" -> [(1, 1), (3, 3), (5, 7)], inclusive ranges."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.append((int(lo), int(hi)))
        else:
            out.append((int(part), int(part)))
    return out


def _spec_matches(ranges: Optional[list[tuple[int, int]]], i: int) -> bool:
    return ranges is None or any(lo <= i <= hi for lo, hi in ranges)


@dataclass
class ItemPattern:
    """One item of an HTK item list, matched against (hmm, state, mix);
    state and mix numbers are HTK's, 1-based (emitting states from 2)."""

    names: list[str]  # glob patterns; ["*"] matches any model
    states: list[tuple[int, int]]
    mixes: Optional[list[tuple[int, int]]]  # None = all

    def matches(self, hmm_name: str, state_no: int, mix_no: int) -> bool:
        return (_spec_matches(self.states, state_no) and _spec_matches(self.mixes, mix_no)
                and any(fnmatchcase(hmm_name, pat) for pat in self.names))


def parse_item_list(text: str) -> list[ItemPattern]:
    """The body of a `{...}` item list (braces optional)."""
    # braces only delimit (possibly several) item groups: drop them all
    text = text.replace("{", "").replace("}", "").strip()
    # split on the commas outside (...) and [...]
    items, depth, cur = [], 0, []
    for ch in text:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    out = []
    for raw in items:
        raw = raw.strip()
        if not raw:
            continue
        m = _ITEM_RE.match(raw)
        if not m:
            raise ValueError(f"unsupported item pattern: {raw!r}")
        if m.group("names") is not None:
            names = [n.strip() for n in m.group("names").split(",") if n.strip()]
        else:
            names = [m.group("name").strip()]
        mixes = _parse_index_spec(m.group("mix")) if m.group("mix") else None
        out.append(ItemPattern(names=names, states=_parse_index_spec(m.group("state")),
                               mixes=mixes))
    return out


@dataclass
class BaseClasses:
    name: str = ""
    mmf_id_mask: str = "*"
    parameters: str = "MIXBASE"
    num_classes: int = 0
    class_items: dict[int, list[ItemPattern]] = field(default_factory=dict)  # 1-based

    def class_of(self, hmm_name: str, state_no: int, mix_no: int) -> int:
        """Base class of one Gaussian component; 0 if no class matches."""
        for cls in sorted(self.class_items):
            if any(it.matches(hmm_name, state_no, mix_no) for it in self.class_items[cls]):
                return cls
        return 0


def _tokenize(path: str) -> list[str]:
    with open(path, "r", errors="replace") as fd:
        return _TOKEN_RE.findall(fd.read())


def _kw(tok: Optional[str]) -> Optional[str]:
    return tok.strip("<>").upper() if tok and tok.startswith("<") else None


def _macro_name(toks: list[str], pos: int, macro: str) -> tuple[str, int]:
    """The name after a keyword that references a macro (`<BASECLASS> ~b
    "name"`); returns (name, next position)."""
    if pos < len(toks) and toks[pos] == macro:
        pos += 1
    if pos < len(toks):
        return toks[pos].strip('"'), pos + 1
    return "", pos


def parse_baseclass(path: str) -> BaseClasses:
    toks = _tokenize(path)
    bc = BaseClasses()
    pos = 0
    while pos < len(toks):
        t, k = toks[pos], _kw(toks[pos])
        if t == "~b" and pos + 1 < len(toks):
            bc.name = toks[pos + 1].strip('"')
            pos += 2
        elif k == "MMFIDMASK":
            bc.mmf_id_mask = toks[pos + 1]
            pos += 2
        elif k == "PARAMETERS":
            bc.parameters = toks[pos + 1].upper()
            pos += 2
        elif k == "NUMCLASSES":
            bc.num_classes = int(toks[pos + 1])
            pos += 2
        elif k == "CLASS":
            cls = int(toks[pos + 1])
            pos += 2
            # the item list runs from '{' to its matching '}' (tokens may
            # glue braces to content: rejoin and count the depth)
            parts, depth, started = [], 0, False
            while pos < len(toks):
                tok = toks[pos]
                parts.append(tok)
                depth += tok.count("{") - tok.count("}")
                started = started or "{" in tok
                pos += 1
                if started and depth == 0:
                    break
            bc.class_items[cls] = parse_item_list(" ".join(parts))
        else:
            pos += 1
    if bc.num_classes == 0:
        bc.num_classes = max(bc.class_items, default=0)
    return bc


@dataclass
class RegTree:
    name: str = ""
    baseclass_name: str = ""
    children: dict[int, list[int]] = field(default_factory=dict)  # empty for terminals
    node_classes: dict[int, list[int]] = field(default_factory=dict)  # terminal -> classes

    def terminal_classes(self, node: int) -> list[int]:
        """Every base class under `node` (its own if it is terminal)."""
        if node in self.node_classes:
            return list(self.node_classes[node])
        out: list[int] = []
        for ch in self.children.get(node, []):
            out.extend(self.terminal_classes(ch))
        return out


def parse_regtree(path: str) -> RegTree:
    toks = _tokenize(path)
    rt = RegTree()
    pos = 0
    while pos < len(toks):
        t, k = toks[pos], _kw(toks[pos])
        if t == "~r" and pos + 1 < len(toks):
            rt.name = toks[pos + 1].strip('"')
            pos += 2
        elif k == "BASECLASS":
            rt.baseclass_name, pos = _macro_name(toks, pos + 1, "~b")
        elif k in ("NODE", "TNODE"):
            idx, n = int(toks[pos + 1]), int(toks[pos + 2])
            table = rt.children if k == "NODE" else rt.node_classes
            table[idx] = [int(x) for x in toks[pos + 3:pos + 3 + n]]
            pos += 3 + n
        else:
            pos += 1
    return rt


@dataclass
class MeanXformSet:
    """A parsed multi-class transform file: transform number (1-based) ->
    InputXform (A, b); base class -> transform number; XFORMKIND."""

    name: str = ""
    adapt_kind: str = "BASE"
    kind: str = "MLLRMEAN"
    baseclass_name: str = ""
    regtree_name: str = ""
    xforms: dict[int, InputXform] = field(default_factory=dict)
    class_to_xform: dict[int, int] = field(default_factory=dict)

    def xform_for_class(self, cls: int) -> Optional[InputXform]:
        num = self.class_to_xform.get(cls)
        return self.xforms.get(num) if num is not None else None


def parse_xformset(path: str) -> MeanXformSet:
    """An HTK transform file that may hold several `<LINXFORM>`s: every
    transform by its number, and the `<XFORMWGTSET>` / `<CLASSXFORM>`
    table. A file with no table is one global transform (class 1)."""
    toks = _tokenize(path)
    xs = MeanXformSet()
    pos, cur_num, vec_size = 0, 0, 0
    bias: Optional[np.ndarray] = None
    blocks: list[np.ndarray] = []
    logdet = 0.0

    def flush():
        nonlocal bias, blocks, logdet
        if not blocks and bias is None:
            return
        D = vec_size or sum(b.shape[0] for b in blocks)
        A = np.eye(D)
        off = 0
        for blk in blocks:
            n = blk.shape[0]
            A[off:off + n, off:off + n] = blk
            off += n
        xs.xforms[cur_num] = InputXform(A=A, b=bias if bias is not None else np.zeros(D),
                                        logdet=logdet)
        bias, blocks, logdet = None, [], 0.0

    while pos < len(toks):
        t, k = toks[pos], _kw(toks[pos])
        if t == "~a" and pos + 1 < len(toks):
            xs.name = toks[pos + 1].strip('"')
            pos += 2
        elif k == "ADAPTKIND":
            xs.adapt_kind = toks[pos + 1].upper()
            pos += 2
        elif k == "XFORMKIND":
            xs.kind = toks[pos + 1].upper()
            pos += 2
        elif k == "BASECLASS":
            xs.baseclass_name, pos = _macro_name(toks, pos + 1, "~b")
        elif k == "REGTREE":
            xs.regtree_name, pos = _macro_name(toks, pos + 1, "~r")
        elif k == "LINXFORM":
            flush()
            cur_num = int(toks[pos + 1])
            pos += 2
        elif k == "VECSIZE":
            vec_size = int(toks[pos + 1])
            pos += 2
        elif k == "BIAS":
            n = int(toks[pos + 1])
            bias = np.array([float(x) for x in toks[pos + 2:pos + 2 + n]])
            pos += 2 + n
        elif k == "LOGDET":
            logdet = float(toks[pos + 1])
            pos += 2
        elif k == "XFORM":
            r, c = int(toks[pos + 1]), int(toks[pos + 2])
            blocks.append(np.array([float(x) for x in toks[pos + 3:pos + 3 + r * c]])
                          .reshape(r, c))
            pos += 3 + r * c
        elif k == "CLASSXFORM":
            xs.class_to_xform[int(toks[pos + 1])] = int(toks[pos + 2])
            pos += 3
        else:
            pos += 1
    flush()
    if not xs.xforms:
        raise ValueError(f"{path}: no <LINXFORM> found")
    if not xs.class_to_xform:
        xs.class_to_xform = {1: min(xs.xforms)}
    return xs


def component_classes(models, baseclasses: BaseClasses) -> list[np.ndarray]:
    """Per-GMM (C,) int32 arrays: the base class of each component. Each
    GMM takes the class of its first (hmm, state) occurrence in the model
    scan (HAdapt's); HTK state numbers are the emitting index + 2 and
    mixture numbers are 1-based."""
    out: list[Optional[np.ndarray]] = [None] * len(models.gmm_means)
    for hi, hmm_name in enumerate(models.hmm_names):
        for s, gi in enumerate(models.hmm_gmm_inds[hi]):
            gi = int(gi)
            if out[gi] is None:
                out[gi] = np.array([baseclasses.class_of(hmm_name, s + 2, m + 1)
                                    for m in range(models.gmm_means[gi].shape[0])],
                                   dtype=np.int32)
    return [c if c is not None else np.zeros(models.gmm_means[i].shape[0], dtype=np.int32)
            for i, c in enumerate(out)]


def _classes(models, xset: MeanXformSet, baseclasses: Optional[BaseClasses]) -> np.ndarray:
    """The flat class of every component (GMM by GMM): all 1 without base
    classes or for a single global transform, else `component_classes`."""
    if baseclasses is None or (len(xset.xforms) == 1
                               and xset.class_to_xform == {1: min(xset.xforms)}):
        return np.ones(sum(len(m) for m in models.gmm_means), np.int64)
    return np.concatenate(component_classes(models, baseclasses)).astype(np.int64)


def _class_xforms(xset: MeanXformSet, classes: np.ndarray) -> dict:
    """class -> (A, b) for every class of `classes` that has a transform."""
    out = {}
    for c in np.unique(classes).tolist():
        xf = xset.xform_for_class(c) if c > 0 else None
        if xf is not None:
            out[c] = (xf.A, xf.b)
    return out


def transform_rows(arrays: list[np.ndarray], classes: np.ndarray, xforms: dict,
                   device="cuda", square: bool = False) -> list[np.ndarray]:
    """The rows of the per-GMM (C_g, D) arrays stacked into one float64
    (N, D) matrix on `device`; the rows of class c (`classes`, length N)
    become rows @ A.T + b for c's (A, b) in `xforms` (with `square`:
    rows @ (A.T ** 2), the diagonal of A diag(rows) A^T), one product a
    class; other rows are kept. Split back into host arrays."""
    dev = resolve_device(device)
    rows = torch.as_tensor(np.concatenate(arrays), dtype=torch.float64).to(dev)
    cls = torch.as_tensor(classes).to(dev)
    out = rows.clone()
    for c, (A, b) in xforms.items():
        sel = torch.nonzero(cls == c).squeeze(1)
        At = torch.as_tensor(A, dtype=torch.float64).to(dev).T
        if square:
            out[sel] = rows[sel] @ (At * At)
        else:
            out[sel] = rows[sel] @ At + torch.as_tensor(b, dtype=torch.float64).to(dev)
    host = out.cpu().numpy()
    offsets = np.cumsum([0] + [len(a) for a in arrays])
    return [host[offsets[i]:offsets[i + 1]] for i in range(len(arrays))]


def apply_mllr_means(models, xset: MeanXformSet, baseclasses: Optional[BaseClasses] = None,
                     device="cuda"):
    """Model-space MLLR: a copy of `models` with each Gaussian mean
    transformed by its regression class's transform, in float64 on
    `device`. Without base classes, or for a single-transform set, every
    component takes transform 1 (`with_mean_transform`)."""
    classes = _classes(models, xset, baseclasses)
    return models.with_params(means=transform_rows(
        models.gmm_means, classes, _class_xforms(xset, classes), device))


def apply_mllr_var(models, xset: MeanXformSet, baseclasses: Optional[BaseClasses] = None,
                   device="cuda"):
    """Model-space MLLRVAR: per class c with transform H_c,
    sigma'^2 = diag(H_c Sigma H_c^T), i.e. sigma'^2_d = sum_j H[d, j]^2
    sigma^2_j (exact for the diagonal H HTK estimates for diagonal
    systems). Means and weights unchanged."""
    classes = _classes(models, xset, baseclasses)
    return models.with_params(variances=transform_rows(
        models.gmm_vars, classes, _class_xforms(xset, classes), device, square=True))


def apply_mllr_cov(models, xset: MeanXformSet, device="cuda"):
    """Global model-space covariance adaptation (MLLRCOV / SEMIT:
    Sigma' = H Sigma H^T), by N(x; mu, H Sigma H^T) =
    |H|^-1 N(H^-1 x; H^-1 mu, Sigma): returns (adapted models, feature
    InputXform) with means H^-1 mu, log weights less log|H|, and the
    features to pass through x -> H^-1 x. A per-class H would need a
    feature stream per class, so only one transform is taken."""
    if len(set(xset.class_to_xform.values())) != 1:
        raise NotImplementedError(
            "apply_mllr_cov: only a GLOBAL MLLRCOV/SEMIT transform is supported "
            "(per-class covariance rotations need per-class feature streams)")
    dev = resolve_device(device)
    H = torch.as_tensor(xset.xforms[next(iter(set(xset.class_to_xform.values())))].A,
                        dtype=torch.float64).to(dev)
    sign, logdet = torch.linalg.slogdet(H)
    if float(sign) <= 0:
        raise ValueError("apply_mllr_cov: transform must have |H| > 0")
    Hinv = torch.linalg.inv(H)
    logdet = float(logdet)
    n = sum(len(m) for m in models.gmm_means)
    means = transform_rows(models.gmm_means, np.ones(n, np.int64),
                           {1: (Hinv.cpu().numpy(), np.zeros(H.shape[0]))}, dev)
    ms = models.with_params(means=means,
                            log_weights=[w - logdet for w in models.gmm_log_weights])
    return ms, InputXform(A=Hinv.cpu().numpy(), b=np.zeros(H.shape[0]), logdet=-logdet)
