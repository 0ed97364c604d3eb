"""Fused decode scan: the whole per-frame search step in one CUDA kernel.

Counterpart of `juicer_tpu/decoder/pallas_scan.py` (`PallasDecodeScan`).
The kernel `csrc/frame_step.cu` runs one thread block per utterance with
the frame loop inside the block and the frontier in shared memory; it
computes what `TorchDecoder._frame_step` computes and is held to it bit
for bit. `TorchDecoder.run` is its plain PyTorch version: a
`FusedDecodeScan` given CPU tensors runs that, and given CUDA tensors
launches the kernel or raises.

The carry is `TorchDecoder`'s own (the nested dict `_init_carry` builds,
same shapes and dtypes), so the two routes can resume from each other's
state.

`ys` is compact. The JAX class and `TorchDecoder.run` write seven dense
(T, B, K) record planes, a real record only where a winner with a word
label landed and filler elsewhere; the kernel writes only the records
that landed:

  - `records` (B, cap, 8) int32: per utterance its records in (frame,
    slot) order, which is ascending record id `t*K + slot`; the eight
    words are `REC_WORDS` (id, prev, seq, score, ac, lm, src, arc), the
    three floats as their bit patterns (`compact_records` of a float64
    decoder's planes gives int64 words with float64 bits; the kernel
    decodes only float32). Only the first `rec_count[-1, b]`
    rows of utterance b are written; the kernel's arena has cap = T*K;
  - `rec_count` (T, B) int32: the records of this call up to the end of
    each frame;
  - the eight (T, B) best-final snapshots and counters, as before.

`compact_records` turns the dense planes into this form and is the plain
version of the kernel's output stage; `expand_records` is its inverse.

`assemble_results` does not copy the arena: a second kernel of the same
source, the best-path walk (`walk_paths`; plain version
`walk_paths_plain`), follows each utterance's best path through it on
the card and writes a header and the path's records, and the host copies
those (`read_paths`, at most two copies) and builds the words from them.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses

import numpy as np
import torch

from .._cuda_build import load
from .core import (BF_FIELDS, NEG, REC_FIELDS, REC_WORDS, RECORD_WORDS, TorchDecoder,
                   float_view, written_records)
from ..utils import trace

SNAP_NAMES = tuple("bf_" + f for f in BF_FIELDS) + ("n_active", "n_cand")
# the dense form (`TorchDecoder.run`, the JAX class) and the compact form
REC_NAMES = REC_FIELDS + SNAP_NAMES
YS_NAMES = ("records", "rec_count") + SNAP_NAMES
_INT_RECS = ("rec_prev", "rec_seq", "rec_src", "rec_arc", "bf_path", "bf_seq",
             "bf_src", "n_active", "n_cand")
_FLOAT_WORDS = tuple(f in ("rec_score", "rec_ac", "rec_lm") for f in REC_WORDS)
_NEG = -1.0e30
_FILLER = dict(rec_prev=-1, rec_seq=0, rec_score=_NEG, rec_ac=_NEG, rec_lm=_NEG,
               rec_src=-1, rec_arc=-1)

# what one block may take of an H100 SM's shared memory (dynamic, opt-in),
# less the kernel's static bytes (reducers and scan scratch)
SMEM_LIMIT = 232448 - 2048
MAX_THREADS = 512

# argument order of `jtpu_frame_step` (the enums of csrc/frame_step.cu)
_TABLES = ("arc_meta32", "ent_arc", "ent_score", "ent_ac", "ent_seq", "f_score",
           "f_ac", "f_seq", "trP", "emitting", "state_gmm")
_INTS = ("B", "K", "E", "F", "S", "G", "H", "n_arcs", "n_ent", "n_fent", "n_bins",
         "HT", "max_emit_hyps", "n_frames", "t_base", "threads", "rec_cap",
         "hmm_smem")
_FLOATS = ("emit_win", "start_win", "end_win", "word_win", "hist_min", "hist_max")
_N_PTR = len(_TABLES) + 1 + 9 + 15 + len(YS_NAMES)
# the kernel library of `_cuda_build`; the profiling harness names the
# build with cycle counters here before the first launch
LIB_NAME = "frame_step"

# the best-path walk: the words of an utterance's header (`JTPU_WALK_HEAD` of
# the kernel source, which the library's `jtpu_walk_head_names` must repeat;
# `cand_all` takes two words, an int64) and the path rows copied with the
# headers, in one copy; a longer path costs one copy more
HEAD = ("score", "ac", "lm", "path", "seq", "src", "overflow", "len", "status", "missing",
        "max_active", "max_cand", "sum_active", "records", "active_all", "pad",
        "cand_all_lo", "cand_all_hi")
HEAD_WORDS = 20
H = {name: i for i, name in enumerate(HEAD)}
PATH_CAP = 64

counter = trace.LaunchCounter()
walk_counter = trace.LaunchCounter()
_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = load(LIB_NAME)
        lib.jtpu_frame_step.restype = ctypes.c_int
        lib.jtpu_frame_step.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p]
        lib.jtpu_frame_step_smem_bytes.restype = ctypes.c_longlong
        lib.jtpu_frame_step_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.jtpu_frame_step_arg_counts.restype = ctypes.c_int
        lib.jtpu_frame_step_arg_counts.argtypes = [ctypes.c_void_p] * 3
        n = (ctypes.c_int * 3)()
        lib.jtpu_frame_step_arg_counts(
            ctypes.addressof(n), ctypes.addressof(n) + 4, ctypes.addressof(n) + 8)
        if tuple(n) != (_N_PTR, len(_INTS), len(_FLOATS)):
            raise RuntimeError(f"frame_step: the library takes {tuple(n)} arguments, "
                               f"the wrapper passes {(_N_PTR, len(_INTS), len(_FLOATS))}")
        lib.jtpu_walk_paths.restype = ctypes.c_int
        lib.jtpu_walk_paths.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p]
        lib.jtpu_walk_head_words.restype = ctypes.c_int
        lib.jtpu_walk_head_names.restype = ctypes.c_char_p
        layout = (lib.jtpu_walk_head_words(),
                  tuple(lib.jtpu_walk_head_names().decode().split(",")[:-1]))
        if layout != (HEAD_WORDS, HEAD):
            raise RuntimeError(f"walk_paths: the library writes the header {layout}, the "
                               f"wrapper reads {(HEAD_WORDS, HEAD)}")
        _lib = lib
    return _lib


def _rup4(n: int) -> int:
    return (n + 3) & ~3


def hash_size(K: int, E: int) -> int:
    """Slots of the kernel's recombination table: the power of two that
    keeps K live arcs plus E candidates under a load of 2/3."""
    n = 1
    while n < (K + E) * 3 // 2 + 1:
        n *= 2
    return n


def smem_bytes(K: int, E: int, S: int, G: int, n_bins: int, HT: int,
               hmm_words: int = 0) -> int:
    """Dynamic shared memory of one block (`smem_bytes` of the kernel
    source): the hash table, the (S, K) frontier planes and ten (K) work
    planes, seven (E) candidate planes, the histogram, two frames' scores,
    the warps' record counts and, when they are staged, the HMM tables
    (`hmm_words` = H*S*(S+1))."""
    return 8 * HT + 4 * (2 * HT + (3 * (S | 1) + 10) * _rup4(K) + 7 * _rup4(E)
                         + _rup4(n_bins) + 2 * _rup4(G) + _rup4((K + 31) // 32 + 32)
                         + _rup4(hmm_words))


def _dims(dec: TorchDecoder) -> dict:
    sg = np.asarray(dec.art.state_gmm)
    n_bins = dec._n_bins if dec.cfg.max_emit_hyps > 0 else 0
    d = dict(K=dec.K, E=dec.E, S=dec.S, G=max(int(sg.max()) + 1, 1),
             n_bins=n_bins, HT=hash_size(dec.K, dec.E), hmm_words=0)
    # the HMM tables ride in shared memory when they fit beside the rest
    # (47 HMMs of 5 states: 5.6 KB); else the kernel reads them in place
    hmm_words = dec.H * dec.S * (dec.S + 1)
    if smem_bytes(**dict(d, hmm_words=hmm_words)) <= SMEM_LIMIT:
        d["hmm_words"] = hmm_words
    return d


def _meta32(dec: TorchDecoder) -> torch.Tensor:
    """The kernel's copy of the per-arc metadata: (n_arcs + 2, 8) int32 rows
    [hmm, no word label, entry base, entry fan, final base, final fan, 0, 0],
    one 32-byte row where the plain version's int64 table has 48 bytes.
    Cached with the decoder's tables (38 MB at the 2k-word task)."""
    tab = dec.tab
    if "arc_meta32" not in tab:
        meta = tab["arc_meta"]
        m32 = torch.zeros((meta.shape[0], 8), dtype=torch.int32, device=meta.device)
        m32[:, 0] = meta[:, 0]
        m32[:, 1] = meta[:, 1] == 0
        m32[:, 2:6] = meta[:, 2:6]
        tab["arc_meta32"] = m32
    return tab["arc_meta32"]


def _max_fan(dec: TorchDecoder) -> int:
    art = dec.art
    fan = art.__dict__.get("_torch_max_fan")
    if fan is None:
        ex = art.expansion
        fan = int(max(np.diff(ex.row_ptr).max(initial=0),
                      np.diff(ex.frow_ptr).max(initial=0)))
        art.__dict__["_torch_max_fan"] = fan
    return fan


def max_scan_T(dec: TorchDecoder) -> int:
    """Longest run of frames one scan can number: record ids `t*K + slot`
    are int32, so (t0 + T) * K stays below 2**31."""
    return (2**31 - 1) // dec.K


def why_not_fused(dec: TorchDecoder) -> str | None:
    """Why the fused kernel does not cover this decoder (the conditions
    of `fused_eligible`); None when it does."""
    if not isinstance(dec, TorchDecoder):
        return f"a {type(dec).__name__} is not a TorchDecoder"
    if dec.otf:
        return "on-the-fly composition: the kernel searches a static network"
    cfg = dec.cfg
    if dec.dtype != torch.float32:
        return f"dtype {cfg.dtype!r}: the kernel decodes in float32"
    if cfg.histogram_mode != "binned":
        return (f"histogram_mode {cfg.histogram_mode!r}: the kernel thresholds by the "
                f"binned histogram")
    if dec.merge_strategy != "dense":
        return (f"merge_strategy {cfg.merge_strategy!r} takes the sort merge at E={dec.E}; "
                f"the kernel numbers slots as the dense merge does, so its records "
                f"would equal no configuration of the JAX engine")
    if cfg.gen_lattice:
        return "gen_lattice: the kernel writes no lattice records"
    if not 2 <= dec.S <= 8:
        return f"{dec.S} HMM states, the kernel is compiled for 2..8"
    need = smem_bytes(**_dims(dec))
    if need > SMEM_LIMIT:
        return (f"K={dec.K}, E={dec.E}, S={dec.S} need {need} bytes of shared "
                f"memory a block, the card gives {SMEM_LIMIT}")
    # the kernel keeps these in int32: a frame's fan-out sum, the entry
    # bases of `_meta32` and the rows of every table
    sizes = {"K x largest fan-out": dec.K * _max_fan(dec),
             "closure entries": dec.tab["ent_arc"].shape[0],
             "final entries": dec.tab["f_score"].shape[0],
             "metadata rows": dec.n_arcs + 2}
    over = [f"{k} {v:,}" for k, v in sizes.items() if v >= 2**31]
    if over:
        return f"{', '.join(over)} reach 2**31 (int32 in the kernel)"
    if max(dec.K, dec.E, dec.F) >= 0xffff:
        return "K, E and F must stay below 65535"
    return None


def why_not_covered(dec: TorchDecoder, T: int) -> str | None:
    """Why one fused scan does not cover a decode of T frames with this
    decoder; None when it does."""
    why = why_not_fused(dec)
    if why is None and not 0 < T <= max_scan_T(dec):
        why = f"{T} frames, one scan numbers 1..{max_scan_T(dec)}"
    return why


def fused_eligible(dec: TorchDecoder) -> bool:
    """Whether the fused kernel covers this decoder.

    The kernel decodes one configuration of `TorchDecoder`: float32,
    the binned histogram (with or without `max_emit_hyps`), the dense
    merge (`merge_strategy` "dense", or "auto" up to E = 32768; the sort
    merge numbers slots, and so record ids, otherwise) and no lattice
    records, over a static network. float64, `histogram_mode="exact"`,
    the sort merge, `gen_lattice` and on-the-fly composition (a decoder
    with a G) decode only in the plain frame loop `TorchDecoder.run`, as
    they decode only in the JAX engine's `lax.scan` step. The kernel
    adds: 2 <= S <= 8 HMM states; the block's state fits the 227 KB of
    shared memory an H100 block may take (at S=5 and E=1408 that is K up
    to 1024: about 215 KB; `smem_bytes` is the count); fan-out sums fit
    int32; and K, E and F stay below 65535.

    Conditions of the TPU kernel's `pallas_eligible` that went, and why:
    `max_emit_hyps == 0` (the histogram threshold is in the kernel);
    K, E, F multiples of 128 and B a multiple of 8 (TPU tiling; a block
    strides over any K and E and the grid takes any B); at most 65,536
    closure entries, 8,192 final entries, H <= 2048 and 8 MiB of tables
    (tables had to be VMEM-resident and were gathered by one-hot matmul;
    here they stay in device memory and are gathered by index); E <= 2048
    and F <= E (the dense (E, E) compare is a hash table, and finals are
    read in place)."""
    return why_not_fused(dec) is None


def route_of(dec: TorchDecoder):
    """(route, use_fused) of a decoder: ("frame_step", True) where the
    kernel covers it, else ("plain loop: <why_not_fused>", False). On a
    CPU decoder the kernel's route runs its plain version."""
    why = why_not_fused(dec)
    return ("frame_step", True) if why is None else (f"plain loop: {why}", False)


def _check(name, t, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"frame_step: {name} is on {t.device}, the decoder on {device}")
    if t.dtype != dtype:
        raise ValueError(f"frame_step: {name} is {t.dtype}, not {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"frame_step: {name} has shape {tuple(t.shape)}, not {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"frame_step: {name} is not contiguous")


class FusedDecodeScan:
    """The fused decode scan of one `TorchDecoder` and batch size B.

    `__call__(scores, carry=None, t0=0)` takes (T, B, n_gmms) float32
    log-likelihoods and returns `(carry, ys)`. Without a carry it starts
    from the initial propagation (`self.init`, built once by the plain
    code; its records are `self.rec0`); with one it resumes at frame
    `t0`, so a decode in pieces equals the decode in one call. A call on
    CUDA tensors is one launch of the kernel.
    """

    def __init__(self, dec: TorchDecoder, B: int):
        why = why_not_fused(dec)
        if why is not None:
            raise ValueError(f"decoder outside the fused scan's scope: {why}")
        if B < 1:
            raise ValueError(f"batch {B} must be positive")
        self.dec = dec
        self.B = B
        self.dims = _dims(dec)
        # the plain version writes the (T, B) snapshots as the kernel always does
        self._plain = dec
        if not dec.cfg.emit_diagnostics:
            self._plain = copy.copy(dec)
            self._plain.cfg = dataclasses.replace(dec.cfg, emit_diagnostics=True)
        self.init, self.rec0 = dec._init_carry(B)
        # the init records as the walk reads them: (B, K, 8) int32 rows
        # {0, prev, seq, score, ac, lm, src, arc}, frame 0 and float bits
        cols = [torch.zeros_like(self.rec0["rec_prev"], dtype=torch.int32)]
        for name in REC_FIELDS:
            col = self.rec0[name]
            cols.append(col.view(torch.int32) if col.is_floating_point() else col.to(torch.int32))
        self.rec0_rows = torch.stack(cols, dim=2).contiguous()
        # threads a block: a multiple of 32 up to MAX_THREADS
        # (a quarter of K: measured best of 128..512 at K=1024, where some
        # 300 slots are live and a thread's chain of instructions, not the
        # number of warps, sets a phase's time)
        self.threads = min(MAX_THREADS, max(128, -(-dec.K // 128) * 32))

    # ------------------------------------------------------------------

    def _carry_spec(self):
        B, K, S = self.B, self.dec.K, self.dec.S
        f32, i64 = torch.float32, torch.int64
        return (
            (("fr", "arc"), i64, (B, K)), (("fr", "score"), f32, (B, K, S)),
            (("fr", "ac"), f32, (B, K, S)), (("fr", "path"), i64, (B, K, S)),
            (("best_emit",), f32, (B,)), (("best_start",), f32, (B,)),
            (("kth_emit",), f32, (B,)), (("norm",), f32, (B,)),
            (("overflow",), torch.bool, (B,)),
        )

    def _launch(self, scores, carry, t0):
        dec = self.dec
        dev = dec.device
        B, K = self.B, dec.K
        T = scores.shape[0]
        d = self.dims
        _check("scores", scores, dev, torch.float32, (T, B, scores.shape[2]))
        if scores.shape[2] < d["G"]:
            raise ValueError(f"frame_step: scores have {scores.shape[2]} GMMs, the network uses {d['G']}")
        ins = []
        for path, dtype, shape in self._carry_spec():
            t = carry[path[0]] if len(path) == 1 else carry[path[0]][path[1]]
            _check("carry " + ".".join(path), t, dev, dtype, shape)
            ins.append(t)
        lib = _get_lib()
        if lib.jtpu_frame_step_smem_bytes(d["K"], d["E"], d["S"], scores.shape[2],
                                          d["n_bins"], d["HT"], d["hmm_words"]) > SMEM_LIMIT:
            raise ValueError("frame_step: the block's state does not fit shared memory")
        _meta32(dec)

        outs = [torch.empty_like(t) for t in ins]
        bf = {f: torch.empty((B,), device=dev,
                             dtype=torch.float32 if f in ("score", "ac", "lm") else torch.int64)
              for f in BF_FIELDS}
        # the arena holds the worst case, T*K records an utterance, and is
        # touched only where a record is written
        ys = {"records": torch.empty((B, T * K, len(REC_WORDS)), device=dev, dtype=torch.int32),
              "rec_count": torch.empty((T, B), device=dev, dtype=torch.int32)}
        for name in SNAP_NAMES:
            ys[name] = torch.empty((T, B), device=dev, dtype=torch.int32
                                   if name in _INT_RECS else torch.float32)
        tensors = ([dec.tab[k] for k in _TABLES] + [scores] + ins + outs
                   + [bf[f] for f in BF_FIELDS] + [ys[n] for n in YS_NAMES])
        ptrs = (ctypes.c_void_p * _N_PTR)(*[t.data_ptr() for t in tensors])
        cfg = dec.cfg
        hist = cfg.max_emit_hyps > 0
        flts = (ctypes.c_float * len(_FLOATS))(
            cfg.emit_prune_win, cfg.phone_start_prune_win, cfg.phone_end_prune_win,
            cfg.word_prune_win, dec._hist_min if hist else 0.0,
            dec._hist_max if hist else 0.0)
        vals = dict(B=B, K=K, E=dec.E, F=dec.F, S=dec.S, G=scores.shape[2], H=dec.H,
                    n_arcs=dec.n_arcs, n_ent=dec.tab["ent_arc"].shape[0],
                    n_fent=dec.tab["f_score"].shape[0], n_bins=d["n_bins"],
                    HT=d["HT"], max_emit_hyps=cfg.max_emit_hyps,
                    n_frames=T, t_base=t0,
                    threads=self.threads,
                    rec_cap=T * K, hmm_smem=int(d["hmm_words"] > 0))
        ints = (ctypes.c_int * len(_INTS))(*[vals[k] for k in _INTS])
        # the kernel sets its shared-memory opt-in on the current device:
        # make that the device whose stream it is launched on
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.jtpu_frame_step(ptrs, ints, flts, stream)
        if rc != 0:
            raise RuntimeError(f"frame_step: launch failed (code {rc})")
        counter.launches += 1
        fr = dict(zip(("arc", "score", "ac", "path"), outs[:4]))
        carry_out = dict(zip(("best_emit", "best_start", "kth_emit", "norm", "overflow"), outs[4:]),
                         fr=fr, best_final=bf)
        return carry_out, ys

    def __call__(self, scores: torch.Tensor, carry=None, t0: int = 0):
        dec = self.dec
        if scores.dim() != 3 or scores.shape[1] != self.B:
            raise ValueError(f"scores {tuple(scores.shape)} are not (T, {self.B}, n_gmms)")
        T = scores.shape[0]
        t0 = int(t0)
        if t0 < 0 or t0 + T > max_scan_T(dec):
            raise ValueError(f"frames {t0}..{t0 + T} exceed int32 record ids at K={dec.K}")
        if T == 0:
            raise ValueError("frame_step: no frames to decode")
        if carry is None:
            carry = self.init
        if scores.device.type == "cpu":
            # the plain version
            carry, ys, _ = self._plain.run(scores.transpose(0, 1), carry=carry, t0=t0)
            return carry, compact_records(ys, t0)
        return self._launch(scores, carry, t0)


def device_wave(dec: TorchDecoder, dbs: torch.Tensor):
    """A function running one wave of the (B, T, n_gmms) scores `dbs`
    through the decoder's device route, with no copy to the host and no
    traceback: one launch of the frame-step kernel where `route_of` picks
    it, else the plain frame loop `TorchDecoder.run`. It returns the
    wave's carry."""
    _, fused = route_of(dec)
    if fused:
        fs = FusedDecodeScan(dec, dbs.shape[0])
        return lambda: fs(dbs.transpose(0, 1).contiguous())[0]
    return lambda: dec.run(dbs)[0]


def assemble_results(dec: TorchDecoder, fs: FusedDecodeScan, carry, ys, lengths):
    """Per-utterance DecodeResults of a fused-scan batch launched from frame
    0, each read at its true length from the per-frame best-final snapshot
    (the exact padded-batch semantics of `TorchDecoder.decode_scores`).
    The walk finds each best path where the records are (`walk_paths`),
    the host copies the headers and paths (`read_paths`; traced as the
    span `copy`, with the counters of `core.copy_counts` and
    `path_records`, the rows walked and copied) and builds the words from
    them with `TorchDecoder.path_result` (the span `traceback`)."""
    T, B = ys["rec_count"].shape
    lengths = [int(n) for n in lengths]
    with trace.span("copy") as attrs:
        head, rows, nbytes = read_paths(walk_paths(fs, carry, ys, lengths), B, T)
        if attrs is not None:
            cand = np.ascontiguousarray(head[:, H["cand_all_lo"]:H["cand_all_hi"] + 1])
            attrs.update(dtoh_bytes=nbytes, records=int(head[:, H["records"]].sum()),
                         candidates=int(cand.view(np.int64).sum()),
                         active_slot_frames=int(head[:, H["active_all"]].sum()),
                         path_records=int(head[:, H["len"]].sum()))
    with trace.span("traceback") as attrs:
        if attrs is not None:
            attrs["utterances"] = B
        heads = head.tolist()
        bests = head[:, :3].view(np.float32).tolist()
        return [_walked_result(dec, b, T, lengths[b], heads[b], bests[b],
                               rows[:heads[b][H["len"]], b]) for b in range(B)]


def _walked_result(dec: TorchDecoder, b: int, T: int, n: int, head: list, best: list,
                   rows: np.ndarray):
    """The DecodeResult of utterance b from its walk: `head` its header words,
    `best` the best final's score, ac and lm, `rows` its path's rows."""
    if head[H["status"]] == 1:
        raise RuntimeError(f"traceback: no record {head[H['missing']]} of utterance {b}")
    if head[H["status"]] != 0:
        raise RuntimeError(f"traceback: the path of utterance {b} passes {T + 1} records")
    te = n if 0 < n < T else T
    stats = dict(avg_active=head[H["sum_active"]] / te, max_active=head[H["max_active"]],
                 max_cand=head[H["max_cand"]], overflow=bool(head[H["overflow"]]))
    ints = rows.tolist()
    floats = rows[:, 3:6].view(np.float32).tolist()
    path = [(r[1], r[2], f[0], f[1], f[2], r[0], r[6], r[7]) for r, f in zip(ints, floats)]
    return dec.path_result(te, (*best, head[H["seq"]], head[H["src"]]), stats, path)


def walk_paths(fs: FusedDecodeScan, carry, ys, lengths) -> torch.Tensor:
    """The best-path walk of a fused scan launched from frame 0 (`carry`,
    `ys` its output, `lengths` the true lengths): one int32 tensor on the
    scan's device, B headers of `HEAD_WORDS` words (`HEAD`), then the
    paths' rows as (T + 1, B, 8), row r of every utterance together, walk
    order (the best final's record first), each row the record's words
    with its frame for its id; the first min(T + 1, `PATH_CAP`) rows are
    zero past a path's end. On CUDA tensors one launch of the kernel
    `path_walk_kernel` (csrc/frame_step.cu); on CPU tensors its plain
    version `walk_paths_plain`."""
    T, B = ys["rec_count"].shape
    if len(lengths) != B:
        raise ValueError(f"walk_paths: {len(lengths)} lengths for {B} utterances")
    dev = ys["records"].device
    if dev.type == "cpu":
        return walk_paths_plain(ys, carry["best_final"], carry["overflow"], fs.rec0_rows,
                                lengths, fs.dec.K)
    K, cap = fs.dec.K, ys["records"].shape[1]
    # the kernel's arguments in the order of its `enum WalkPtr`
    specs = [("records", ys["records"], torch.int32, (B, cap, 8)),
             ("rec_count", ys["rec_count"], torch.int32, (T, B))]
    specs += [(k, ys[k], torch.int32 if k in _INT_RECS else torch.float32, (T, B))
              for k in SNAP_NAMES]
    specs += [("best_final " + f, carry["best_final"][f],
               torch.float32 if f in ("score", "ac", "lm") else torch.int64, (B,))
              for f in BF_FIELDS]
    specs += [("overflow", carry["overflow"], torch.bool, (B,)),
              ("rec0 rows", fs.rec0_rows, torch.int32, (B, K, 8))]
    for name, t, dtype, shape in specs:
        _check(name, t, dev, dtype, shape)
    lens = torch.tensor(lengths, dtype=torch.int32).pin_memory().to(dev, non_blocking=True)
    out = torch.empty(B * HEAD_WORDS + (T + 1) * B * 8, dtype=torch.int32, device=dev)
    tensors = [t for _, t, _, _ in specs] + [lens, out]
    ptrs = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    ints = (ctypes.c_int * 5)(B, K, T, cap, min(T + 1, PATH_CAP))
    lib = _get_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.jtpu_walk_paths(ptrs, len(ptrs), ints, len(ints), stream)
    if rc != 0:
        raise RuntimeError(f"walk_paths: launch failed (code {rc})")
    walk_counter.launches += 1
    return out


def walk_paths_plain(ys, best_final, overflow, rec0_rows, lengths, K: int) -> torch.Tensor:
    """The plain version of `path_walk_kernel`: the same packed words from
    CPU tensors. Every row that no path reaches reads zero; the kernel
    zeroes only those it copies with the headers."""
    rc = ys["rec_count"].numpy()
    T, B = rc.shape
    out = np.zeros(B * HEAD_WORDS + (T + 1) * B * 8, np.int32)
    head = out[:B * HEAD_WORDS].reshape(B, HEAD_WORDS)
    rows = out[B * HEAD_WORDS:].reshape(T + 1, B, 8)
    recs, r0 = ys["records"].numpy(), rec0_rows.numpy()
    na, nc = ys["n_active"].numpy(), ys["n_cand"].numpy()
    snaps = [ys["bf_" + f].numpy() for f in BF_FIELDS]
    fin = [best_final[f].numpy() for f in BF_FIELDS]
    ovf = overflow.numpy()
    for b, n in enumerate(lengths):
        te = n if 0 < n < T else T
        h = head[b]
        bf = [s[te - 1, b] for s in snaps] if te < T else [f[b] for f in fin]
        h[:3] = np.array(bf[:3], np.float32).view(np.int32)
        h[3:6] = bf[3:6]
        h[H["overflow"]] = int(ovf[b])
        h[H["max_active"]] = na[:te, b].max()
        h[H["max_cand"]] = nc[:te, b].max()
        h[H["sum_active"]] = na[:te, b].sum()
        h[H["records"]] = rc[-1, b]
        h[H["active_all"]] = na[:, b].sum()
        h[H["cand_all_lo"]:H["cand_all_hi"] + 1] = np.array(
            [nc[:, b].astype(np.int64).sum()]).view(np.int32)
        length = status = missing = 0
        if not float(bf[0]) <= NEG / 2:
            ids = recs[b, :, 0]
            pid = int(bf[3])
            while pid != -1:
                if length == T + 1:
                    status = 2
                    break
                row = None
                if pid >= 0:
                    t = pid // K
                    if t < T:
                        lo, hi = (int(rc[t - 1, b]) if t else 0), int(rc[t, b])
                        i = lo + int(np.searchsorted(ids[lo:hi], pid))
                        if i < hi and ids[i] == pid:
                            row = recs[b, i].copy()
                            row[0] = t
                elif pid >= -K:
                    row = r0[b, pid + K]
                if row is None:
                    status, missing = 1, pid
                    break
                rows[length, b] = row
                length += 1
                pid = int(row[1])
        h[H["len"]], h[H["status"]], h[H["missing"]] = length, status, missing
    return torch.from_numpy(out)


def read_paths(packed: torch.Tensor, B: int, T: int):
    """The walk's headers and path rows on the host: the headers with the
    first min(T + 1, `PATH_CAP`) rows in one copy, and the rest of the
    longest path in a second only where a path is longer; from the card
    through pinned memory, each copy waited for. Returns (headers (B,
    HEAD_WORDS), rows (R, B, 8), bytes copied), int32 NumPy arrays."""
    n_head = B * HEAD_WORDS
    copy_rows = min(T + 1, PATH_CAP)
    first = n_head + copy_rows * B * 8
    part = _to_host(packed[:first])
    head = part[:n_head].reshape(B, HEAD_WORDS)
    rows = part[n_head:].reshape(copy_rows, B, 8)
    nbytes = part.nbytes
    longest = int(head[:, H["len"]].max())
    if longest > copy_rows:
        more = _to_host(packed[first:first + (longest - copy_rows) * B * 8])
        rows = np.concatenate([rows, more.reshape(-1, B, 8)])
        nbytes += more.nbytes
    return head, rows, nbytes


def _to_host(t: torch.Tensor) -> np.ndarray:
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def compact_records(ys_dense: dict, t0: int = 0) -> dict:
    """The dense `ys` of `TorchDecoder.run` (seven (T, B, K) record planes,
    the (T, B) snapshots) in the compact form: the plain version of the
    kernel's output stage. A record landed where `rec_seq != 0`; `t0` is
    the number of the planes' first frame (record ids are `t*K + slot`).
    Snapshots that `ys_dense` lacks (`emit_diagnostics=False`) stay out.
    float32 planes give the kernel's int32 words; float64 planes (a
    float64 decoder's) give int64 words that carry the float64 bits."""
    seq = ys_dense["rec_seq"]
    fdt = ys_dense["rec_score"].dtype
    if fdt not in RECORD_WORDS:
        raise ValueError(f"compact_records: {fdt} records have no compact form")
    wdt = RECORD_WORDS[fdt]
    T, B, K = seq.shape
    landed = seq != 0
    rec_count = torch.cumsum(landed.sum(dim=2), dim=0).to(torch.int32)
    n = rec_count[-1].to(torch.int64)
    # (utterance, frame * K + slot) of every record: ascending id per utterance
    b_idx, flat = landed.permute(1, 0, 2).reshape(B, T * K).nonzero(as_tuple=True)
    start = torch.cumsum(n, 0) - n
    pos = torch.arange(b_idx.shape[0], device=seq.device) - start[b_idx]
    words = [(flat + int(t0) * K).to(wdt)]
    for name in REC_FIELDS:
        col = ys_dense[name].permute(1, 0, 2).reshape(B, T * K)[b_idx, flat]
        words.append(col.view(wdt) if col.dtype == fdt else col.to(wdt))
    cap = max(int(n.max()), 1)
    records = torch.zeros((B, cap, len(REC_WORDS)), dtype=wdt, device=seq.device)
    records[b_idx, pos] = torch.stack(words, dim=1)
    out = {"records": records, "rec_count": rec_count}
    out.update({k: ys_dense[k] for k in SNAP_NAMES if k in ys_dense})
    return out


def expand_records(ys: dict, K: int, t0: int = 0) -> dict:
    """The compact `ys` as the dense (T, B, K) planes with their filler
    (-1, 0, -1e30): the inverse of `compact_records`."""
    count = ys["rec_count"]
    T, B = count.shape
    rows, offsets = written_records(ys["records"], count[-1])
    b_idx = torch.repeat_interleave(torch.arange(B, device=rows.device),
                                    offsets[1:] - offsets[:-1])
    flat = rows[:, 0].to(torch.int64) - int(t0) * K
    floats = float_view(rows)
    out = {}
    for w, name in enumerate(REC_WORDS[1:], start=1):
        is_float = _FLOAT_WORDS[w]
        plane = torch.full((B, T * K), _FILLER[name], device=rows.device,
                           dtype=floats.dtype if is_float else torch.int32)
        plane[b_idx, flat] = floats[:, w] if is_float else rows[:, w].to(torch.int32)
        out[name] = plane.view(B, T, K).permute(1, 0, 2).contiguous()
    out.update({k: ys[k] for k in SNAP_NAMES})
    return out


def concat_records(pieces: list) -> dict:
    """The compact `ys` of consecutive calls (a decode in pieces, each
    resumed with `carry=`, `t0=`) as the `ys` of one call."""
    B = pieces[0]["rec_count"].shape[1]
    dev = pieces[0]["records"].device
    parts = [written_records(y["records"], y["rec_count"][-1]) for y in pieces]
    n = torch.stack([off[1:] - off[:-1] for _, off in parts])  # (pieces, B)
    before = torch.cumsum(n, 0) - n
    records = torch.zeros((B, max(int(n.sum(0).max()), 1), len(REC_WORDS)),
                          dtype=pieces[0]["records"].dtype, device=dev)
    counts = []
    for i, (y, (rows, off)) in enumerate(zip(pieces, parts)):
        b_idx = torch.repeat_interleave(torch.arange(B, device=dev), n[i])
        pos = torch.arange(rows.shape[0], device=dev) - off[b_idx] + before[i][b_idx]
        records[b_idx, pos] = rows
        counts.append(y["rec_count"] + before[i].to(torch.int32)[None])
    out = {"records": records, "rec_count": torch.cat(counts)}
    out.update({k: torch.cat([y[k] for y in pieces]) for k in SNAP_NAMES})
    return out


def state_differences(got, want, limit: int = 8) -> list[str]:
    """Where two `(carry, ys)` results of the compact form differ, bit for
    bit: one line per differing field with the count and the first place
    (for a record its frame, utterance and slot), at most `limit` lines.
    Rows of `records` beyond an utterance's count are not compared. Empty
    when equal."""
    (c_got, y_got), (c_want, y_want) = got, want
    K = c_want["fr"]["arc"].shape[1]
    out = []
    pairs = [(k, y_got[k], y_want[k]) for k in ("rec_count",) + SNAP_NAMES]
    if torch.equal(y_got["rec_count"][-1], y_want["rec_count"][-1]):
        r_got, off = written_records(y_got["records"], y_got["rec_count"][-1])
        r_want, _ = written_records(y_want["records"], y_want["rec_count"][-1])
        bad = (r_got != r_want).nonzero()
        if len(bad):
            # the first differing record, named by the id the reference gives it
            i, w = int(bad[0, 0]), int(bad[0, 1])
            b = int(torch.searchsorted(off, i, right=True)) - 1
            rid = int(r_want[i, 0])
            out.append(f"records: {len(bad)} words differ, first {REC_WORDS[w]} of record "
                       f"{i - int(off[b])} of utterance {b} (frame {rid // K}, slot "
                       f"{rid % K}): {int(r_got[i, w])} vs {int(r_want[i, w])}")
    pairs += [(k, c_got[k], c_want[k])
              for k in ("best_emit", "best_start", "kth_emit", "norm", "overflow")]
    pairs += [("fr." + k, c_got["fr"][k], c_want["fr"][k])
              for k in ("arc", "score", "ac", "path")]
    pairs += [("best_final." + f, c_got["best_final"][f], c_want["best_final"][f])
              for f in BF_FIELDS]
    for name, a, b in pairs:
        if len(out) >= limit:
            break
        if a.dtype != b.dtype or a.shape != b.shape:
            out.append(f"{name}: {a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
        elif not torch.equal(a, b):
            bad = (a != b).nonzero()
            at = tuple(int(i) for i in bad[0])
            out.append(f"{name}: {len(bad)} differ, first at {at}: "
                       f"{a[at].item()!r} vs {b[at].item()!r}")
    return out
