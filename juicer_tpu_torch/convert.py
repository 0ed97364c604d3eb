"""Carry the JAX reference's state across to the port, as plain files and
numpy arrays (the port never imports the JAX package).

  - `artifact_from_npz`: an artifact saved by either package's
    `DecoderArtifact.save_npz` (one file format);
  - `gmm_params_from_numpy`: the arrays of the JAX package's
    `FlatGmmParams` (V, M, b, mask);
  - `fused_state_from_jax`: the carry and `ys` of the JAX package's
    `PallasDecodeScan` (as numpy arrays) in the layout and dtypes of the
    port's `FusedDecodeScan`.
"""

from __future__ import annotations

import numpy as np

from .am.models import AcousticModelSet, FlatGmmParams
from .decoder.artifact import DecoderArtifact
from .decoder.network import DecoderNetwork


def artifact_from_npz(path: str, net: DecoderNetwork,
                      models: AcousticModelSet) -> DecoderArtifact:
    return DecoderArtifact.load_npz(path, net, models)


def gmm_params_from_numpy(V, M, b, mask) -> FlatGmmParams:
    """V, M (D, G*C); b (G*C,); mask (G, C) bool."""
    mask = np.asarray(mask, bool)
    V = np.asarray(V, np.float32)
    G, C = mask.shape
    if V.shape[1] != G * C or np.shape(M) != V.shape or np.shape(b) != (G * C,):
        raise ValueError("V, M (D, G*C), b (G*C,) and mask (G, C) disagree")
    return FlatGmmParams(
        n_gmms=G, max_comps=C, vec_size=V.shape[0], V=V,
        M=np.asarray(M, np.float32), b=np.asarray(b, np.float32), mask=mask,
    )


_JAX_INT_YS = ("rec_prev", "rec_seq", "rec_src", "rec_arc", "bf_path", "bf_seq",
               "bf_src", "n_active", "n_cand")


def fused_state_from_jax(carry: dict, ys: dict):
    """The JAX `PallasDecodeScan` state as the port lays it out.

    The TPU kernel carries ids in float32, the frontier as (S, B, K)
    planes and per-utterance scalars as (B, 1) columns; the port carries
    ids as int64, the frontier as (B, K, S) and scalars as (B,). The TPU
    carry has no `kth_emit` or `best_final` (no histogram; the snapshot
    is in `ys`), so neither has the result. `ys` keeps its (T, B, K) and
    (T, B) shapes; integer fields become int32: the dense form, which the
    port's compact `ys` gives through `fused_scan.expand_records`. Returns
    (carry, ys) of numpy arrays."""
    def col(name, dtype=np.float32):
        return np.asarray(carry[name])[:, 0].astype(dtype)

    def planes(name, dtype):
        return np.ascontiguousarray(
            np.asarray(carry[name]).transpose(1, 2, 0)).astype(dtype)

    out = {
        "fr": {
            "arc": np.asarray(carry["arc"]).astype(np.int64),
            "score": planes("sc", np.float32),
            "ac": planes("ac", np.float32),
            "path": planes("pa", np.int64),
        },
        "best_emit": col("best_emit"),
        "best_start": col("best_start"),
        "norm": col("norm"),
        "overflow": col("ovf") > 0.5,
    }
    ys_out = {k: np.asarray(v).astype(np.int32 if k in _JAX_INT_YS else np.float32)
              for k, v in ys.items()}
    return out, ys_out
