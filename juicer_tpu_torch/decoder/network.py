"""Runtime search network: the CSR arrays the artifact build reads.

The arrays and `load_npz` of `juicer_tpu/decoder/network.py`. Networks
are built by the JAX package's offline pipeline and arrive as its npz
file (`DecoderNetwork.save_npz`); weights there are already decoder-
internal (negated costs, higher = better).
"""

from __future__ import annotations

import numpy as np

LOG_ZERO = -1e30

_ARRAYS = ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight",
           "row_ptr", "final_weight")


class DecoderNetwork:
    """Arcs sorted by source state (CSR `row_ptr`), final weights, and the
    scalars the decoder reads."""

    arc_src: np.ndarray  # (n_arcs,) int32
    arc_dst: np.ndarray  # (n_arcs,) int32
    arc_ilabel: np.ndarray  # (n_arcs,) int32; 0 = epsilon, else HMM index + 1
    arc_olabel: np.ndarray  # (n_arcs,) int32; 0 = epsilon
    arc_weight: np.ndarray  # (n_arcs,) f64
    row_ptr: np.ndarray  # (n_states+1,) int64
    final_weight: np.ndarray  # (n_states,) f64; LOG_ZERO = not final

    @classmethod
    def load_npz(cls, path: str) -> "DecoderNetwork":
        z = np.load(path)
        net = cls()
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

    def arcs_from(self, state: int) -> range:
        return range(int(self.row_ptr[state]), int(self.row_ptr[state + 1]))
