"""Whole runs of the tiny cell on the CPU (the program's plain version):
a sound run is correct; a run with the timed path broken underneath is
not; the control is not; a measuring run without a card prints no
result; and what the runs load.

The cell has one chip, so the fault of an exchange between chips left
out does not arise."""

import dataclasses
import json
import os
import subprocess
import sys
import time

import pytest

from pb import cell as cell_run, spec

from conftest import BENCH, CELL, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "juicer_tpu"}


@pytest.fixture(scope="module")
def tiny(tiny_root):
    return spec.load_cell("wsj2k.tiny", False, repo=tiny_root,
                          bench=os.path.join(tiny_root, "port_bench"))


@pytest.fixture(scope="module")
def program(tiny):
    from pb.program import Program

    return Program(os.path.join(tiny.repo, tiny.config["task_dir"]), tiny.config["point"],
                   "cpu", {})


def run_with(tiny, program_cls, seed=2**31 + 3):
    return cell_run.run(tiny, seed, 0.5, False, "cpu", time.perf_counter(),
                        program_cls=lambda *a: program_cls)


class Faulty:
    """The program with a fault planted where the answers are produced."""

    def __init__(self, program, fault):
        self.program, self.fault = program, fault
        self.G, self.K = program.G, program.K
        self.last = None

    def wave(self, feats, lengths, span):
        p = self.program
        if self.fault in ("half", "half_flagged"):
            # half of the batch left out; the other half's answers stand in,
            # flagged as overflowed with "half_flagged"
            h = max(1, len(lengths) // 2)
            res, sc = p.wave(feats[:h], lengths[:h], span)
            res = [res[b] if b < h else dataclasses.replace(
                res[b % h], overflow=self.fault == "half_flagged") for b in range(len(lengths))]
            return res, sc.repeat(-(-len(lengths) // h), 1, 1)[:len(lengths)]
        res, sc = p.wave(feats, lengths, span)
        if self.fault == "flag_all":
            # every answer flagged as overflowed, as a search that gives up
            res = [dataclasses.replace(r, overflow=True) for r in res]
        if self.fault == "unchanged":
            # a step that hands back its previous state
            prev, self.last = self.last, (res, sc)
            return prev if prev is not None else (res, sc)
        if self.fault == "word":
            res = [dataclasses.replace(r, words=r.words[:-1] + [r.words[-1] + 1]) for r in res]
        if self.fault == "score":
            sc = sc.clone()
            sc[:, :, 7] += 0.01
        return res, sc


def test_sound_run_is_correct(tiny, program):
    out = run_with(tiny, program)
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "wave_p95_ms", "setup_s"}
    assert list(out)[-1] == "check"


@pytest.mark.parametrize("fault", ["unchanged", "half", "half_flagged", "flag_all", "word",
                                   "score"])
def test_broken_timed_path_is_not_correct(tiny, program, fault):
    out = run_with(tiny, Faulty(program, fault))
    assert out["correct"] is False, (fault, out["check"])


def test_flagged_answers_are_failed_and_decode_no_frames(tiny, program):
    out = run_with(tiny, Faulty(program, "flag_all"))
    assert out["failed"] == out["attempted"] > 0
    assert out["check"]["flagged_share"]["value"] == 1.0
    assert out["metrics"]["frames_per_s"]["value"] == 0.0


def test_control_is_not_correct(tiny):
    import control

    numbers = control.control_numbers(tiny, 7, "cpu")
    assert numbers["score_gap"] > tiny.limits["limits"]["score_gap"]
    from pb import check

    assert not check.verdict(numbers, tiny.limits["limits"])


def test_measuring_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip()


def _loaded(code: str, cwd: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         capture_output=True, text=True, cwd=cwd, timeout=600,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_and_yardstick_load_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {BENCH!r})\n"
            "import control, pb.check, pb.reference, pb.traffic, pb.task, pb.trace, "
            "pb.opcount, pb.intervals, pb.editdist, pb.spec, pb.cell")
    loaded = _loaded(code, BENCH)
    assert not loaded & (FORBIDDEN | {"juicer_tpu_torch"})


def test_a_whole_run_loads_no_jax(tiny_root):
    bench = os.path.join(tiny_root, "port_bench")
    code = (f"import sys, time; sys.path.insert(0, {bench!r}); sys.path.insert(1, {tiny_root!r})\n"
            "from pb import cell, spec\n"
            f"c = spec.load_cell('wsj2k.tiny', True, repo={tiny_root!r}, bench={bench!r})\n"
            "out = cell.run(c, 5, 0.2, True, 'cpu', time.perf_counter())\n"
            "assert out['correct'], out['check']")
    loaded = _loaded(code, tiny_root)
    assert "juicer_tpu_torch" in loaded
    assert not loaded & FORBIDDEN
