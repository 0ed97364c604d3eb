"""The probe kernels' plain versions (`juicer_tpu_torch/ops/probe_cuda.py`,
driven by `harness/pallas_probe.py`) against the nine Pallas kernel bodies
of `scripts/pallas_probe.py` (:45-99, copied here as they are), run through
`pl.pallas_call(..., interpret=True)` on the CPU with the same numpy
inputs: exactly for the copies and gathers D-I, within 1e-5 relative for
the products A-C (their sums run in another order). Also: the extract
cases the card holds the kernel to, against numpy's slicing; the gather's
rows for indices the one-hot matmul matches nothing with (fractions,
negatives, past the table, NaN) are zeros, as the one-hot body gives; the
tool exits 1 when a probe fails.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from juicer_tpu_torch.harness import pallas_probe
from juicer_tpu_torch.ops import probe_cuda

from test_torch_decoder import _one_torch_thread  # noqa: F401 (fixture)
from test_torch_gpu import EXTRACT_CASES, _shifted

E, CW, W = 256, 128, 16
RTOL = 1e-5


# ---- the probe bodies of scripts/pallas_probe.py, as they are -------------

def kA(x_ref, t_ref, o_ref):
    x2 = x_ref[...].reshape(8 * E, CW)
    o_ref[...] = jnp.dot(x2, t_ref[...],
                         preferred_element_type=jnp.float32)


def kB(x_ref, t_ref, o_ref):
    x2 = x_ref[...].reshape(8 * E, CW)
    r = jnp.dot(x2, t_ref[...], preferred_element_type=jnp.float32)
    o_ref[...] = r.reshape(8, E, W)


def kC(x_ref, t_ref, o_ref):
    o_ref[...] = jax.lax.dot_general(
        x_ref[...], t_ref[...], (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)


def kD(x_ref, o_ref):
    o_ref[...] = x_ref[...][:, :, 3]


def kE(i_ref, t_ref, o_ref):
    io = jax.lax.broadcasted_iota(jnp.int32, (8, E, CW), 2)
    oh = (i_ref[...][:, :, None] == io.astype(jnp.float32))
    r = jnp.dot(oh.astype(jnp.float32).reshape(8 * E, CW), t_ref[...],
                preferred_element_type=jnp.float32)
    o_ref[...] = r


def kF(x_ref, o_ref):
    r = x_ref[...]
    o_ref[...] = r[:, 3:4]


def kG(x_ref, o_ref):
    o_ref[...] = x_ref[...][:, 3].reshape(8, E)


def kH(x_ref, o_ref):
    o_ref[...] = x_ref[...][0 * E:(0 + 1) * E, :]


def kI(i_ref, t_ref, o_ref):
    acc = None
    for c0 in range(0, 1024, 512):
        io = jax.lax.broadcasted_iota(jnp.int32, (8, E, 512), 2)
        oh = (i_ref[...][:, :, None] == (io.astype(jnp.float32) + c0))
        r = jnp.dot(oh.astype(jnp.float32).reshape(8 * E, 512),
                    t_ref[c0:c0 + 512, :],
                    preferred_element_type=jnp.float32)
        acc = r if acc is None else acc + r
    o_ref[...] = acc


# name -> (body, output shape, the inputs' names)
BODIES = {
    "A_collapse_matmul_2d": (kA, (8 * E, W), ("x3", "tab")),
    "B_plus_reshape_back_3d": (kB, (8, E, W), ("x3", "tab")),
    "C_batched_dot_general": (kC, (8, E, W), ("x3", "tab")),
    "D_minor_col_extract_3d": (kD, (8, E), ("xd",)),
    "E_onehot_gather_2d": (kE, (8 * E, W), ("idx", "tab")),
    "F_col_extract_2d": (kF, (8 * E, 1), ("xf",)),
    "G_col_to_8E_reshape": (kG, (8, E), ("xg",)),
    "H_row_slice_2d": (kH, (E, W), ("xh",)),
    "I_chunked_gather_1024": (kI, (8 * E, W), ("idx1024", "tab1024")),
}


def interpret(body, shape, *args):
    f = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
                       interpret=True)
    return np.asarray(f(*[jnp.asarray(a.numpy()) for a in args]))


@pytest.fixture(scope="module")
def inputs():
    return pallas_probe.inputs("cpu")


@pytest.mark.parametrize("name", list(BODIES))
def test_plain_version_equals_the_probe_body(inputs, name):
    body, shape, names = BODIES[name]
    kernel, exact, fn = pallas_probe.PROBES[name]
    want = interpret(body, shape, *[inputs[n] for n in names])
    for ops in (pallas_probe.PLAIN, pallas_probe.KERNEL):  # KERNEL on CPU tensors: plain
        got = fn(ops, inputs).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        if exact:
            assert np.array_equal(got, want), name
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=name)
    assert kernel in probe_cuda.KERNELS
    assert exact == (kernel != "probe_product")


@pytest.mark.parametrize("case", EXTRACT_CASES, ids=str)
def test_extract_cases_equal_numpy_slicing(case):
    """The cases the card holds the extract kernel to (`EXTRACT_CASES` of
    `test_torch_gpu.py`, each a path of the kernel), through
    `probe_cuda.extract` on CPU tensors (the plain version), against
    numpy's slicing of the same array."""
    rows, cols, row0, n_rows, col0, n_cols, shift = case
    a = np.random.default_rng(list(case)).random((rows, cols))
    x = _shifted(a, torch.device("cpu"), shift)
    got = probe_cuda.extract(x, row0, n_rows, col0, n_cols).numpy()
    assert got.shape == (n_rows, n_cols) and got.dtype == np.float32
    assert np.array_equal(got, a.astype(np.float32)[row0:row0 + n_rows, col0:col0 + n_cols])


def test_gather_of_unmatched_indices_is_zero(inputs):
    """Indices no one-hot column equals give zero rows, as kE's product."""
    idx = inputs["idx"].clone()
    idx[0, :6] = torch.tensor([2.5, -1.0, 128.0, float("nan"), 127.0, 0.0])
    want = interpret(kE, (8 * E, W), idx, inputs["tab"])
    got = probe_cuda.gather(idx.reshape(-1), inputs["tab"]).numpy()
    assert np.array_equal(got, want)
    assert not got[:4].any() and got[4:6].any()


def test_probe_tool_exit_codes(monkeypatch, capsys):
    assert pallas_probe.main(["--cpu"]) == 0
    assert capsys.readouterr().out.count("PASS ") == 9
    monkeypatch.setattr(pallas_probe.PLAIN, "extract",
                        lambda x, *a: probe_cuda.extract_plain(x, *a) + 1.0)
    assert pallas_probe.main(["D", "--cpu"]) == 1
    assert "FAIL D_minor_col_extract_3d" in capsys.readouterr().out


# ---- the tool's host-side logic (no card needed) ---------------------------


@pytest.mark.parametrize("name", list(pallas_probe.PROBES))
def test_library_call_computes_the_probe(inputs, name):
    """Each probe's one PyTorch call (`pallas_probe.LIBRARY`, timed beside
    the kernel on the card) computes what its plain version computes:
    exactly for D-I, within 1e-5 relative for A-C."""
    _, exact, fn = pallas_probe.PROBES[name]
    got, want = fn(pallas_probe.LIBRARY, inputs), fn(pallas_probe.PLAIN, inputs)
    assert pallas_probe.agree(got, want, exact)[0]


def test_run_records_the_floor(inputs):
    """Each probe's record carries the library call's, the floor's and the
    one-float yardstick's times beside the kernel's, and their timer (None
    on the CPU, where nothing is timed)."""
    records = pallas_probe.run("cpu", "A")
    assert [r["name"] for r in records] == ["A_collapse_matmul_2d"]
    rec, = records
    assert rec["ok"] and rec["timer"] is None and rec["plain_timer"] is None
    for key in ("ms", "library_ms", "floor_ms", "one_float_ms", "plain_ms"):
        assert rec[key] is None, key


def test_yardsticks_refuse_the_cpu():
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe_cuda.empty("cpu")
    with pytest.raises(ValueError, match="not a CUDA device"):
        probe_cuda.touch(torch.zeros(1), torch.zeros(1))
