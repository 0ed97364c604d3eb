"""Carry the JAX reference's state across to the port, as plain files and
numpy arrays (the port never imports the JAX package).

  - `artifact_from_npz`: an artifact saved by either package's
    `DecoderArtifact.save_npz` (one file format);
  - `gmm_params_from_numpy`: the arrays of the JAX package's
    `FlatGmmParams` (V, M, b, mask).
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
