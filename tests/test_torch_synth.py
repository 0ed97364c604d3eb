"""The port's synthetic task (`juicer_tpu_torch.utils.synth`) against the
JAX package's (`juicer_tpu.utils.synth`), on the CPU.

`make_synth_task` builds its lexicon, models, CLG and artifact from one
numpy seed with the offline toolchain. For the same arguments both
packages must give the same task bit for bit: the network's arrays and
scalars, every model parameter, the artifact's tables and its closure
expansion, and the features `synth_utterance` samples from the same
generator.
"""

import numpy as np
import pytest
import torch

from juicer_tpu.utils.synth import make_synth_task as jax_make_synth_task

from juicer_tpu_torch.utils.synth import SynthTask, make_synth_task

NET_ARRAYS = ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight", "row_ptr",
              "final_weight")
NET_SCALARS = ("n_states", "n_arcs", "init_state", "word_end_marker", "sil_marker", "sp_marker")
CASES = {
    "small": dict(n_words=12, n_phones=8, n_comps=4, vec_size=6, seed=3),
    "default_widths": dict(n_words=30, seed=0),
    "penalty": dict(n_words=20, n_phones=10, n_emit_states=2, n_comps=2, vec_size=13,
                    word_ins_pen=-0.5, seed=7),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread, as in the other port test files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CASES))
def tasks(request):
    kw = CASES[request.param]
    return make_synth_task(**kw), jax_make_synth_task(**kw)


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_network_equals_jax(tasks):
    got, want = tasks
    assert isinstance(got, SynthTask) and got.vec_size == want.vec_size
    for k in NET_ARRAYS:
        assert same_bits(getattr(got.network, k), getattr(want.network, k)), k
    for k in NET_SCALARS:
        assert getattr(got.network, k) == getattr(want.network, k), k
    assert got.network.n_arcs > 0


def test_models_and_lexicon_equal_jax(tasks):
    got, want = tasks
    gm, wm = got.models, want.models
    assert gm.hmm_names == wm.hmm_names and gm.vec_size == wm.vec_size
    for k in ("gmm_means", "gmm_vars", "gmm_log_weights", "trans_mats", "hmm_gmm_inds"):
        assert len(getattr(gm, k)) == len(getattr(wm, k))
        for a, b in zip(getattr(gm, k), getattr(wm, k)):
            assert same_bits(a, b), k
    assert list(gm.hmm_trans_ind) == list(wm.hmm_trans_ind)
    gf, wf = gm.flat_params(), wm.flat_params()
    for k in ("V", "M", "b", "mask"):
        assert same_bits(getattr(gf, k), getattr(wf, k)), k
    gl, wl = got.lexicon, want.lexicon
    assert gl.vocab.words == wl.vocab.words and gl.phone_set.phones == wl.phone_set.phones
    assert [(e.phones, e.log_prior, e.vocab_index) for e in gl.entries] == [
        (e.phones, e.log_prior, e.vocab_index) for e in wl.entries]


def test_artifact_equals_jax(tasks):
    got, want = tasks
    ga, wa = got.artifact, want.artifact
    assert (ga.n_hmm_arcs, ga.S) == (wa.n_hmm_arcs, wa.S)
    n = 0
    for k, v in vars(ga).items():
        if isinstance(v, np.ndarray):
            assert same_bits(v, getattr(wa, k)), k
            n += 1
    assert n >= 9
    for k, v in vars(ga.expansion).items():
        assert same_bits(v, getattr(wa.expansion, k)), f"expansion.{k}"


@pytest.mark.parametrize("seed", [5, 6])
def test_features_equal_jax(tasks, seed):
    got, want = tasks
    words = got.lexicon.vocab.words
    pick = np.random.default_rng(seed).integers(len(words), size=4)
    utt = [words[i] for i in pick]
    a = got.synth_utterance(utt, np.random.default_rng(seed))
    b = want.synth_utterance(utt, np.random.default_rng(seed))
    assert a.dtype == np.float32 and a.shape[1] == got.vec_size and len(a) > 0
    assert same_bits(a, b)
