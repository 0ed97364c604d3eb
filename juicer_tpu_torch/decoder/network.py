"""Runtime search network: the CSR arrays the artifact build reads.

A copy of `juicer_tpu/decoder/network.py`, the rebuild of `WFSTNetwork`'s
load semantics (`WFSTNetwork.cpp:371-618`):
  - FSM file weights are costs (negative log); the internal arc weight is
    -cost * lm_scale, plus the word insertion penalty on arcs with an
    output label (higher = better, Viterbi is max-plus); final weights
    likewise negated and scaled;
  - auxiliary ('#') symbols become epsilon at load (`remove_aux` "both",
    or "input" for the CL of on-the-fly composition, whose output labels
    the grammar reads);
  - the sil / sp input labels are found for word-end pruning;
  - the initial state is the source of the first arc line.

Arcs are sorted by source state (CSR `row_ptr`), keeping the file's arc
order within a state. `save_npz` / `load_npz` are the CLI's
`-writeBinaryFiles` cache, in the JAX class's format (each reads the
other's files).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..fst import EPSILON, Fst, SymbolTable, read_fsm, read_symbols

LOG_ZERO = -1e30

_ARRAYS = ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight",
           "row_ptr", "final_weight")


class DecoderNetwork:
    arc_src: np.ndarray  # (n_arcs,) int32
    arc_dst: np.ndarray  # (n_arcs,) int32
    arc_ilabel: np.ndarray  # (n_arcs,) int32; 0 = epsilon, else HMM index + 1
    arc_olabel: np.ndarray  # (n_arcs,) int32; 0 = epsilon
    arc_weight: np.ndarray  # (n_arcs,) f64
    row_ptr: np.ndarray  # (n_states+1,) int64
    final_weight: np.ndarray  # (n_states,) f64; LOG_ZERO = not final

    def __init__(self, fst: Fst, in_syms: Optional[SymbolTable] = None,
                 out_syms: Optional[SymbolTable] = None, lm_scale: float = 1.0,
                 ins_pen: float = 0.0, remove_aux: str = "both"):
        in_syms = in_syms if in_syms is not None else fst.isyms
        out_syms = out_syms if out_syms is not None else fst.osyms
        self.in_syms = in_syms
        self.out_syms = out_syms
        self.lm_scale = lm_scale
        self.ins_pen = ins_pen

        src, dst, il, ol, w = fst.arcs_numpy()
        weight = -w * lm_scale
        weight = np.where(ol > 0, weight + ins_pen, weight)

        def aux_mask(labels, syms):
            n = max(int(labels.max(initial=0)) + 1, 1)
            return np.array([0 < i < len(syms) and syms.is_auxiliary(i) for i in range(n)],
                            dtype=bool)

        if remove_aux in ("both", "input") and in_syms is not None:
            il = np.where(aux_mask(il, in_syms)[il], EPSILON, il)
        if remove_aux == "both" and out_syms is not None:
            ol = np.where(aux_mask(ol, out_syms)[ol], EPSILON, ol)

        order = np.argsort(src, kind="stable")
        self.arc_src = src[order].astype(np.int32)
        self.arc_dst = dst[order].astype(np.int32)
        self.arc_ilabel = il[order].astype(np.int32)
        self.arc_olabel = ol[order].astype(np.int32)
        self.arc_weight = weight[order].astype(np.float64)
        self.n_states = fst.num_states
        self.n_arcs = len(self.arc_src)
        self.row_ptr = np.zeros(self.n_states + 1, dtype=np.int64)
        np.add.at(self.row_ptr, self.arc_src + 1, 1)
        self.row_ptr = np.cumsum(self.row_ptr)

        self.init_state = fst.start
        self.final_weight = np.full(self.n_states, LOG_ZERO, dtype=np.float64)
        for s, fw in fst.finals.items():
            self.final_weight[s] = -fw * lm_scale

        # wordEndMarker = max(in, out) label + 1 (`WFSTNetwork.cpp:566-569`)
        max_in = int(self.arc_ilabel.max(initial=0))
        max_out = int(self.arc_olabel.max(initial=0))
        if in_syms is not None:
            max_in = max(max_in, len(in_syms) - 1)
        if out_syms is not None:
            max_out = max(max_out, len(out_syms) - 1)
        self.word_end_marker = max(max_in, max_out) + 1

        # the reference finds the word-end pruning markers by the literal
        # strings "sil" / "sp", whatever -silMonophone / -pauseMonophone
        # say (`WFSTNetwork.cpp:605-616`)
        self.sil_marker = in_syms.find("sil") if in_syms is not None else -1
        self.sp_marker = in_syms.find("sp") if in_syms is not None else -1

    @classmethod
    def from_files(cls, fsm_fname: str, in_syms_fname: Optional[str] = None,
                   out_syms_fname: Optional[str] = None, lm_scale: float = 1.0,
                   ins_pen: float = 0.0, remove_aux: str = "both") -> "DecoderNetwork":
        isy = read_symbols(in_syms_fname) if in_syms_fname else None
        osy = read_symbols(out_syms_fname) if out_syms_fname else None
        return cls(read_fsm(fsm_fname), isy, osy, lm_scale, ins_pen, remove_aux)

    def arcs_from(self, state: int) -> range:
        return range(int(self.row_ptr[state]), int(self.row_ptr[state + 1]))

    # -- binary cache ------------------------------------------------------

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path, **{k: getattr(self, k) for k in _ARRAYS},
            n_states=self.n_states, init_state=self.init_state,
            word_end_marker=self.word_end_marker, sil_marker=self.sil_marker,
            sp_marker=self.sp_marker, lm_scale=self.lm_scale, ins_pen=self.ins_pen)

    @classmethod
    def load_npz(cls, path: str) -> "DecoderNetwork":
        z = np.load(path)
        net = cls.__new__(cls)
        net.in_syms = None
        net.out_syms = None
        for k in _ARRAYS:
            setattr(net, k, z[k])
        net.n_states = int(z["n_states"])
        net.n_arcs = len(net.arc_src)
        net.init_state = int(z["init_state"])
        net.word_end_marker = int(z["word_end_marker"])
        net.sil_marker = int(z["sil_marker"])
        net.sp_marker = int(z["sp_marker"])
        net.lm_scale = float(z["lm_scale"])
        net.ins_pen = float(z["ins_pen"])
        return net
