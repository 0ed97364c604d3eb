"""`juicer_tpu_torch/harness/pipeline_scale.py` against the JAX package's
`scripts/pipeline_scale.py`, on the CPU: at 50 and 200 words the three
synthetic files (`lex.dict`, `phones.lst`, `lm.arpa`) are byte for byte
the JAX script's, and every machine of the pipeline (L, G, L o G, its
epsilon normalisation, determinisation and minimisation) has the JAX
one's states and arcs, arc for arc (labels and weights exactly).
"""

import importlib.util
import os

import numpy as np
import pytest

from juicer_tpu.compile import GramGen as JaxGramGen, GramType as JaxGramType
from juicer_tpu.compile import LexGen as JaxLexGen
from juicer_tpu.fst import algos as jax_algos

from juicer_tpu_torch.harness import pipeline_scale

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("lex.dict", "phones.lst", "lm.arpa")


@pytest.fixture(scope="module")
def jax_script():
    spec = importlib.util.spec_from_file_location(
        "_jax_pipeline_scale", os.path.join(ROOT, "scripts", "pipeline_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_pipeline(jax_script, tmp, n_words):
    """The JAX script's stages (its `main` body) on its own synth files."""
    lex, lmf = jax_script.synth_task(tmp, n_words)
    G = JaxGramGen(lex.vocab, JaxGramType.NGRAM, lm_fname=lmf).build()
    L = JaxLexGen(lex).build(output_aux_phones=True)
    lg = jax_algos.compose(jax_algos.closure(jax_algos.arcsort(L)),
                           jax_algos.determinize(jax_algos.arcsort(G)))
    lg2 = jax_algos.epsnormalize_input(lg)
    det = jax_algos.determinize(lg2)
    return dict(L=L, G=G, LG=lg, epsnorm=lg2, det=det, min=jax_algos.minimize(det))


@pytest.mark.parametrize("n_words", [50, 200])
def test_pipeline_equals_the_jax_script(jax_script, tmp_path, n_words):
    got_dir, want_dir = tmp_path / "port", tmp_path / "jax"
    got_dir.mkdir()
    want_dir.mkdir()
    got = pipeline_scale.run_size(str(got_dir), n_words)
    want = jax_pipeline(jax_script, str(want_dir), n_words)
    for f in FILES:
        assert (got_dir / f).read_bytes() == (want_dir / f).read_bytes(), f
    assert set(got["seconds"]) == {"build G+L", "detG+closeL+compose", "epsnormalize",
                                   "determinize", "minimize"}
    for name, w in want.items():
        g = got["machines"][name]
        assert (g.num_states, g.num_arcs, g.start) == (w.num_states, w.num_arcs, w.start), name
        for field in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight"):
            assert np.array_equal(np.asarray(getattr(g, field)), np.asarray(getattr(w, field))), (
                name, field)
        assert g.finals == w.finals, name
