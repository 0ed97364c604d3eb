"""juicer CLI of the port: the batch decoder front end, on the card.

The counterpart of `juicer_tpu/cli/juicer.py` (`jtpu-juicer`), with the
same flags, files and output text, plus `-device` (default `cuda`;
`-device cpu` runs the plain PyTorch path). It loads the vocabulary, the
acoustic models (HTK MMF, cached as `<mmf>.npz` with -writeBinaryFiles,
or a hybrid phone list with priors), the network (AT&T text FSM and
symbol files, cached as `<fsm>.npz`, with the LM scale and insertion
penalty applied at load), checks that they agree, builds the decode
artifact and a `TorchDecoder` on the device, and decodes an input list
with the batch tester (WER and real-time factor), or float32 frames or
PCM audio from stdin with `-loop`.

Inputs: HTK, LNA or npy feature files, read on the host; or wav audio
(`-inputFormat factory`), turned into MFCC features by the front end
(`harness/frontend.py`) on the device, a batch's files in one pass, the
features handed to the GMM kernel where they are. `-loop -audioDevice`
captures S16LE PCM (an ALSA device through `arecord`, or `-` for stdin)
through the streaming front end (`harness/capture.py`) on the device.
The front end's device is printed on stderr and in the log
(`front end: ...`).

Models: `-mllrXformFile` (with `-regClassFile` base classes) adapts the
Gaussian means by model-space MLLR (`am/regtree.py`), in float64 on the
device, before the GMM kernel's parameters are packed.

On the card every utterance is scored by one launch of the GMM kernel,
on the device, and decoded without a copy of its scores to the host:
  - `-batchSize` > 1: the utterances of a batch are edge-padded on the
    device and decoded by one `BatchDecoder` call (one launch of the
    frame-step kernel);
  - `-batchSize 1`: `TorchDecoder.decode_scores`, one launch each;
  - `-loop`: a streaming session, one launch a chunk;
  - `-latticeDir` / `-modelLevelOutput`: `decode_scores_lattice`.
The route is chosen once from `fused_scan.why_not_fused` (and for each
batch from `why_not_covered`) and printed on stderr and in the log as
`route: frame_step kernel` or `route: plain frame loop (<reason>)`;
on-the-fly composition (-gramFsmFName) and lattices take the plain frame
loop, which no kernel covers. A kernel's error is never caught, and no
route is retried on another. `-refCore` decodes with the oracle token
passing on the host (`decoder/ref_core.py`, `RefOtfDecoder` with a G)
from one host copy of each utterance's GMM scores; its route line says
so. It builds no artifact, and refuses -loop and -modelLevelOutput, as
the JAX CLI does.

The seconds of each stage (models, mllr, FSM parse, network, artifact,
tables, features or front end, decode, output) are printed on stderr and
in the log at the end, and handed back by `run`.

The HTKLib-backed flags (-useHModels, -htkConfig, -parentXformDir) are
refused, as the JAX CLI refuses them.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
import numpy as np


def make_parser():
    p = argparse.ArgumentParser(prog="jtpu-juicer-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # resources
    p.add_argument("-lexFName", required=True)
    p.add_argument("-sentStartWord", default=None)
    p.add_argument("-sentEndWord", default=None)
    p.add_argument("-fsmFName", required=True)
    p.add_argument("-inSymsFName", required=True)
    p.add_argument("-outSymsFName", required=True)
    p.add_argument("-htkModelsFName", default=None)
    p.add_argument("-monoListFName", default=None)
    p.add_argument("-priorsFName", default=None)
    p.add_argument("-statesPerModel", type=int, default=0)
    # decoding parameters
    p.add_argument("-lmScaleFactor", type=float, default=1.0)
    p.add_argument("-insPenalty", type=float, default=0.0)
    p.add_argument("-mainBeam", type=float, default=0.0, help="emitting-state beam width")
    p.add_argument("-phoneStartBeam", type=float, default=0.0)
    p.add_argument("-phoneEndBeam", type=float, default=0.0)
    p.add_argument("-wordEmitBeam", type=float, default=0.0)
    p.add_argument("-maxHyps", type=int, default=0, help="histogram pruning top-N")
    p.add_argument("-refCore", action="store_true",
                   help="decode with the oracle token passing on the host")
    p.add_argument("-maxInsts", type=int, default=8192)
    p.add_argument("-expandBudget", type=int, default=32768)
    p.add_argument("-batchSize", type=int, default=1, help="utterances decoded per device batch")
    p.add_argument("-device", default="cuda",
                   help="torch device: cuda (the default, the card) or cpu")
    # input / output
    p.add_argument("-inputFName", default=None,
                   help="list of feature files (not needed with -loop)")
    p.add_argument("-inputFormat", default="htk", choices=["htk", "lna", "npy", "factory"],
                   help="factory: wav audio through the MFCC front end on the device")
    p.add_argument("-framesPerSec", type=float, default=100.0)
    p.add_argument("-outputFName", default=None)
    p.add_argument("-outputFormat", default="verbose",
                   choices=["ref", "trans", "mlf", "xmlf", "verbose"])
    p.add_argument("-refFName", default=None)
    p.add_argument("-removeSentMarks", action="store_true")
    p.add_argument("-writeBinaryFiles", action="store_true")
    p.add_argument("-logFName", default=None)
    p.add_argument("-latticeDir", default=None, help="write per-utterance lattices here")
    p.add_argument("-modelLevelOutput", action="store_true",
                   help="output model (phone) sequences instead of words")
    # speaker adaptation: per-speaker CMLLR input transforms
    p.add_argument("-inputXformDir", default=None)
    p.add_argument("-inputXformExt", default=".xform")
    p.add_argument("-speakerNamePattern", default=None,
                   help="regex with one capture group extracting the speaker "
                        "from the utterance name")
    # model-space MLLR with regression classes
    p.add_argument("-mllrXformFile", default=None,
                   help="HTK transform file (MLLRMEAN <XFORMSET>) applied to "
                        "the Gaussian means at load time")
    p.add_argument("-regClassFile", default=None,
                   help="HTK ~b base-class file assigning mixture components "
                        "to regression classes for -mllrXformFile")
    p.add_argument("-doModelsIOTest", action="store_true",
                   help="round-trip the acoustic models through the binary "
                        "format and verify scores agree")
    p.add_argument("-genTestSeqs", action="store_true",
                   help="print random label sequences accepted by the network")
    # on-the-fly composition: -fsmFName is CL, G comes separately
    p.add_argument("-gramFsmFName", default=None)
    p.add_argument("-gramInSymsFName", default=None)
    p.add_argument("-gramOutSymsFName", default=None)
    p.add_argument("-pushing", action="store_true",
                   help="label-and-weight pushing in on-the-fly composition")
    p.add_argument("-loop", action="store_true",
                   help="streaming mode: read float32 feature frames (or PCM "
                        "with -audioDevice) from stdin, print partial "
                        "hypotheses as they converge")
    p.add_argument("-loopChunk", type=int, default=50,
                   help="frames per streaming chunk in -loop mode")
    p.add_argument("-audioDevice", default=None,
                   help="in -loop mode, capture S16LE PCM audio: an ALSA "
                        "device name (through arecord), or '-' to read raw "
                        "PCM from stdin, through the streaming MFCC front end")
    p.add_argument("-audioSampleRate", type=int, default=16000)
    # reference flags accepted for drop-in compatibility (`juicer.cpp:169-294`)
    p.add_argument("-silMonophone", default="",
                   help="validated against -monoListFName (the word-end "
                        "pruning markers are the literal 'sil'/'sp' strings)")
    p.add_argument("-pauseMonophone", default="",
                   help="validated against -monoListFName")
    p.add_argument("-basicCore", action="store_true", help="accepted")
    p.add_argument("-threading", action="store_true", help="accepted; obsolete")
    p.add_argument("-blockSize", type=int, default=0, help="accepted; obsolete")
    p.add_argument("-tiedListFName", default=None, help="accepted")
    p.add_argument("-cdSepChars", default=None, help="accepted")
    p.add_argument("-useHModels", action="store_true", help="unsupported (HTKLib)")
    p.add_argument("-htkConfig", default=None, help="unsupported (HTKLib)")
    p.add_argument("-parentXformDir", default=None,
                   help="rejected, as the JAX CLI rejects it")
    p.add_argument("-parentXformExt", default=".xform")
    from .. import __version__

    p.add_argument("-version", action="version", version=f"juicer_tpu_torch {__version__}")
    return p


def load_models(args):
    """The model set of -htkModelsFName (through its npz cache) or of a
    hybrid phone list; not adapted (`adapt_models`)."""
    from ..am import AcousticModelSet
    from ..lexicon import PhoneSet

    if args.htkModelsFName:
        cache = args.htkModelsFName + ".npz"
        if os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(
                args.htkModelsFName):
            return AcousticModelSet.load_npz(cache)
        models = AcousticModelSet.from_mmf(args.htkModelsFName)
        if args.writeBinaryFiles:
            models.save_npz(cache)
        return models
    if args.priorsFName and args.monoListFName:
        ps = PhoneSet(args.monoListFName)
        priors = np.loadtxt(args.priorsFName).reshape(-1)
        return AcousticModelSet.hybrid(list(ps.phones), priors, args.statesPerModel)
    raise SystemExit("juicer: need -htkModelsFName or (-monoListFName -priorsFName)")


def adapt_models(args, models, device):
    """-mllrXformFile (and -regClassFile): the means adapted by
    model-space MLLR, in float64 on `device`."""
    from ..am.regtree import apply_mllr_means, parse_baseclass, parse_xformset

    bc = parse_baseclass(args.regClassFile) if args.regClassFile else None
    return apply_mllr_means(models, parse_xformset(args.mllrXformFile), bc, device=device)


def do_models_io_test(models):
    """Round-trip the model set through the npz format and verify
    observation scores agree (`testModelsIO`, `HTKModels.cpp:2253-2327`)."""
    import tempfile

    from ..am import AcousticModelSet

    rng = np.random.default_rng(0)
    x = rng.normal(size=models.vec_size)
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "m.npz")
        models.save_npz(p)
        m2 = AcousticModelSet.load_npz(p)
        for h in range(models.n_hmms):
            for j in range(1, models.get_num_states(h) - 1):
                a = models.calc_output(h, j, x)
                b = m2.calc_output(h, j, x)
                if abs(a - b) > 1e-9:
                    raise SystemExit(f"modelsIOTest FAILED: hmm {h} state {j}: {a} vs {b}")
    print(f"modelsIOTest passed: {models.n_hmms} HMMs round-tripped")


def check_consistency(net, models, vocab):
    """Network input symbols must match the model set index for index and
    output symbols the vocabulary (`juicer.cpp:1001-1061`)."""
    problems = []
    if net.in_syms is not None:
        for i, name in enumerate(models.hmm_names):
            sym = net.in_syms[i + 1] if i + 1 < len(net.in_syms) else None
            if sym is not None and sym != name and not sym.startswith("#"):
                problems.append(f"inSym {i + 1} = {sym!r} but model {i} = {name!r}")
                if len(problems) > 5:
                    break
    if net.out_syms is not None:
        for i in range(vocab.n_words):
            if vocab.get_num_pronuns(i) <= 0:
                continue
            sym = net.out_syms[i + 1] if i + 1 < len(net.out_syms) else None
            if sym is not None and sym != vocab.get_word(i):
                problems.append(f"outSym {i + 1} = {sym!r} but vocab {i} = {vocab.get_word(i)!r}")
                if len(problems) > 5:
                    break
    if problems:
        raise SystemExit("juicer: resource consistency check failed:\n  " + "\n  ".join(problems))


def check_monophones(args):
    """-silMonophone / -pauseMonophone must be in -monoListFName, as the
    reference's MonophoneLookup requires (`MonophoneLookup.cpp:83-94`)."""
    if not ((args.silMonophone or args.pauseMonophone) and args.monoListFName):
        return
    from ..lexicon import PhoneSet

    phones = PhoneSet(args.monoListFName)
    for flag, name in (("-silMonophone", args.silMonophone),
                       ("-pauseMonophone", args.pauseMonophone)):
        if name and phones.get_index(name) < 0:
            raise SystemExit(f"juicer: {flag} {name!r} not in monophone list "
                             f"{args.monoListFName}")


@dataclass
class RunReport:
    """What one run of the CLI did: its route, its front end (wav or PCM
    input), the seconds of each stage, the batch tester's per-utterance
    results and seconds of speech (none in -loop mode). It holds no
    reference to the decoder."""

    route: str = ""
    front_end: str = ""
    stages: dict = field(default_factory=dict)
    results: list = field(default_factory=list)
    speech_time: float = 0.0


def _say(line: str) -> None:
    from ..utils.log import LogFile

    print(line, file=sys.stderr, flush=True)
    LogFile.printf("%s\n", line)


@contextmanager
def _stage(report: RunReport, name: str):
    """Adds the seconds of a `with` block to report.stages[name]."""
    t0 = time.perf_counter()
    yield
    report.stages[name] = report.stages.get(name, 0.0) + time.perf_counter() - t0


def run_loop(args, dec, score, out_names, use_fused, device):
    """Streaming decode: float32 frames (vec_size each) on stdin, or with
    -audioDevice S16LE PCM through the streaming front end on `device`;
    converged partial words printed as they stabilise, the final
    hypothesis at EOF (`-loop`, `DecoderBatchTest.cpp` loop path with
    PARTIAL_DECODING)."""
    D = dec.art.models.vec_size
    chunk_frames = max(1, args.loopChunk)
    stream = dec.stream(use_fused=use_fused)

    def emit(feats):
        for h in stream.feed(score(feats)):
            name = out_names[h.word - 1] if 0 < h.word <= len(out_names) else "<?>"
            print(f"partial: {name} (frame {h.end_frame})", flush=True)

    if args.audioDevice:
        from ..harness.capture import PcmSource, capture_features

        src = (PcmSource(stream=sys.stdin.buffer, sample_rate=args.audioSampleRate)
               if args.audioDevice == "-"
               else PcmSource(device=args.audioDevice, sample_rate=args.audioSampleRate))
        try:
            for feats in capture_features(src, chunk_samples=chunk_frames * 160,
                                          device=device):
                if feats.shape[1] != D:
                    raise SystemExit(f"juicer: front end dim {feats.shape[1]} != model dim {D}")
                emit(feats)
        finally:
            src.close()
    else:
        raw = sys.stdin.buffer
        frame_bytes = 4 * D
        while True:
            data = raw.read(frame_bytes * chunk_frames)
            n = len(data) // frame_bytes
            if n == 0:
                break
            emit(np.frombuffer(data[: n * frame_bytes], dtype="<f4").reshape(n, D))
    final = stream.finish()
    words = " ".join(out_names[w - 1] if 0 < w <= len(out_names) else "<?>"
                     for w in final.words)
    print(f"final: {words}", flush=True)
    return 0


def run(argv=None) -> RunReport:
    """The CLI's work for `argv`; `main` is this with an exit code."""
    args = make_parser().parse_args(argv)
    if args.useHModels or args.htkConfig or args.parentXformDir:
        raise SystemExit("juicer: HTKLib-backed HModels are not supported; use "
                         "-mllrXformFile/-regClassFile (MLLR) or -inputXformDir (CMLLR)")
    for flag, on in (("-loop", args.loop), ("-modelLevelOutput", args.modelLevelOutput)):
        if on and args.refCore:
            raise SystemExit(f"juicer: {flag} requires the decoder core, not -refCore")
    import torch

    from .. import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        raise SystemExit(f"juicer: {e}")

    from ..decoder import (DecoderNetwork, RefDecoder, RefOtfDecoder, TorchDecoder,
                           TorchDecoderConfig)
    from ..decoder.artifact import DecoderArtifact
    from ..decoder.fused_scan import why_not_covered, why_not_fused
    from ..fst import read_fsm, read_symbols
    from ..harness.batch import BatchTester, OutputFormat
    from ..lexicon import Vocabulary
    from ..utils.log import LogFile, get_env

    report = RunReport()
    if args.logFName:
        LogFile.open(args.logFName)
    # environment tunables (the Tracter GetEnv analogue)
    args.maxInsts = get_env("MAX_INSTS", args.maxInsts)
    args.expandBudget = get_env("EXPAND_BUDGET", args.expandBudget)

    vocab = Vocabulary(args.lexFName, "!", args.sentStartWord, args.sentEndWord)
    with _stage(report, "models"):
        models = load_models(args)
    if args.mllrXformFile:
        with _stage(report, "mllr"):
            models = adapt_models(args, models, device)

    if args.doModelsIOTest:
        do_models_io_test(models)
    if args.genTestSeqs:
        from ..fst import algos

        f = read_fsm(args.fsmFName)
        osy = read_symbols(args.outSymsFName)
        for il, ol, cost in algos.generate_sequences(f, 10, seed=0, max_len=200):
            print(" ".join(osy[o] for o in ol), f"({cost:.3f})")

    otf = args.gramFsmFName is not None
    cache = args.fsmFName + ".npz"
    if not otf and os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(
            args.fsmFName):
        with _stage(report, "network"):
            net = DecoderNetwork.load_npz(cache)
    else:
        with _stage(report, "fsm parse"):
            isy, osy = read_symbols(args.inSymsFName), read_symbols(args.outSymsFName)
            fsm = read_fsm(args.fsmFName)
        with _stage(report, "network"):
            net = DecoderNetwork(fsm, isy, osy, lm_scale=args.lmScaleFactor,
                                 ins_pen=args.insPenalty,
                                 remove_aux="input" if otf else "both")
            del fsm
        if args.writeBinaryFiles and not otf:
            net.save_npz(cache)
    check_consistency(net, models, vocab)

    g_net = None
    if otf:
        from ..decoder.otf import GNetwork

        with _stage(report, "fsm parse"):
            g_fst = read_fsm(args.gramFsmFName)
            phi = read_symbols(args.gramInSymsFName).find("#phi") if args.gramInSymsFName else -1
        with _stage(report, "network"):
            g_net = GNetwork(g_fst, lm_scale=args.lmScaleFactor, phi_label=phi)

    beams = dict(phone_start_prune_win=args.phoneStartBeam, emit_prune_win=args.mainBeam,
                 phone_end_prune_win=args.phoneEndBeam, word_prune_win=args.wordEmitBeam,
                 max_emit_hyps=args.maxHyps)
    if not args.refCore:  # the oracle reads the network itself
        with _stage(report, "artifact"):
            art = DecoderArtifact(net, models)
    with _stage(report, "tables"):
        if not args.refCore:
            dec = TorchDecoder(art, TorchDecoderConfig(
                max_insts=args.maxInsts, expand_budget=args.expandBudget, **beams,
                gen_lattice=args.latticeDir is not None or args.modelLevelOutput,
                otf_pushing=args.pushing), device=device, g_network=g_net)
        if models.hybrid_mode:
            log_priors = torch.as_tensor(models.log_priors, device=device)
        else:
            from ..ops.gmm import make_gmm_scorer

            scorer = make_gmm_scorer(models.flat_params(), device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def score(feats) -> torch.Tensor:
        """(T, D) features (host, or a tensor from the front end, used where
        it lies) -> (T, n_gmms) scores on the device: one launch of the GMM
        kernel on the card; float64 for a hybrid set (log posteriors minus
        float64 log priors, as the JAX CLI's numpy does; the decoder reads
        them in its dtype)."""
        x = (feats.to(device, torch.float32) if isinstance(feats, torch.Tensor)
             else torch.from_numpy(np.array(feats, dtype=np.float32)).to(device))
        # hybrid HMM/ANN: log posterior - log prior (`HTKFlatModels.cpp:196-220`)
        return x - log_priors[None, :] if models.hybrid_mode else scorer(x)

    # the route: the frame-step kernel where it covers the decoder on the
    # card, else the plain frame loop, named with the reason; or the oracle
    if args.refCore:
        why = "-refCore"
        report.route = ("route: oracle token passing on the host (-refCore; GMM scores on "
                        f"{device.type}, one host copy an utterance)")
    else:
        why = why_not_fused(dec) if device.type == "cuda" else f"device {device.type}"
        report.route = ("route: frame_step kernel" if why is None
                        else f"route: plain frame loop ({why})")
    _say(report.route)
    factory = args.inputFormat == "factory" and not args.loop
    if factory or (args.loop and args.audioDevice):
        what = "wav files, a batch in one pass" if factory else "PCM, streamed"
        report.front_end = f"front end: MFCC of {what} on {device}"
        _say(report.front_end)

    def use_fused(T: int) -> bool:
        if why is not None:
            return False
        why_T = why_not_covered(dec, T)
        if why_T is not None:
            _say(f"route: plain frame loop ({why_T}) for a decode of {T} frames")
        return why_T is None

    lattice_mode = args.latticeDir is not None or args.modelLevelOutput

    if args.refCore:
        ref = (RefOtfDecoder(net, g_net, models, **beams) if otf
               else RefDecoder(net, models, **beams))

    def decode_fn(feats):
        sc = score(feats)
        if args.refCore:
            host = sc.cpu().numpy()  # one copy an utterance, read per (t, gmm)
            return ref.decode(score_fn=lambda t, g: float(host[t, g]), n_frames=len(host))
        if lattice_mode:
            res, lattice = dec.decode_scores_lattice(sc, use_fused=False)
            if args.modelLevelOutput:
                # model-level (phone) output: the input labels of the
                # lattice's best path are the entered models
                # (`juicer.cpp:607-622`)
                from ..decoder.results import DecodeResult, WordHyp
                from ..fst import algos

                _, il, _ = algos.shortest_path(lattice)
                res = DecodeResult(
                    words=il, word_hyps=[WordHyp(m, -1, 0.0, 0.0, 0.0) for m in il],
                    score=res.score, acoustic_score=res.acoustic_score,
                    lm_score=res.lm_score, n_frames=res.n_frames)
            return (res, lattice) if args.latticeDir is not None else res
        T = int(sc.shape[0])
        T_pad = max(dec.T_BUCKET, -(-T // dec.T_BUCKET) * dec.T_BUCKET)
        return dec.decode_scores(sc, use_fused=use_fused(T_pad))

    speaker_xforms = None
    if args.inputXformDir:
        from ..am.xform import SpeakerXforms

        speaker_xforms = SpeakerXforms(args.inputXformDir, args.inputXformExt,
                                       args.speakerNamePattern)
    check_monophones(args)
    out_names = list(models.hmm_names) if args.modelLevelOutput else vocab.words
    tester = BatchTester(
        decode_fn,
        word_names=out_names,
        output_format=OutputFormat(args.outputFormat),
        output_file=args.outputFName,
        frames_per_sec=args.framesPerSec,
        remove_sent_marks=args.removeSentMarks,
        sent_start_index=vocab.sent_start_index,
        sent_end_index=vocab.sent_end_index,
        feature_kind=args.inputFormat,
        lna_outputs=models.vec_size if models.hybrid_mode else 0,
        lattice_dir=args.latticeDir,
        speaker_xforms=speaker_xforms,
        device=device,
    )
    if args.loop:
        with _stage(report, "decode"):
            run_loop(args, dec, score, out_names, use_fused=why is None, device=device)
        _report_stages(report)
        return report

    if not args.inputFName:
        raise SystemExit("juicer: -inputFName is required (or use -loop)")
    specs = BatchTester.read_input_list(args.inputFName)
    refs = None
    if args.refFName:
        refs = BatchTester.read_references(args.refFName, specs, vocab.get_index)

    batch_fn = None
    if args.batchSize > 1 and not lattice_mode and not args.refCore:
        from ..parallel.batch import BatchDecoder

        routes = {True: BatchDecoder(dec, use_fused=True),
                  False: BatchDecoder(dec, use_fused=False)}

        def batch_fn(feats_list):
            scs = [score(f) for f in feats_list]
            lengths = [int(s.shape[0]) for s in scs]
            t_max = max(lengths)
            padded = torch.stack([torch.cat([s, s[-1:].expand(t_max - len(s), -1)])
                                  for s in scs])
            return routes[use_fused(t_max)].decode_scores_batch(padded, lengths)

    tester.run(specs, refs, batch_fn=batch_fn, batch_size=args.batchSize)
    st = report.stages
    st["front end" if factory else "features"] = tester.load_time
    st["decode"] = tester.decode_time
    st["output"] = tester.run_time - tester.decode_time - tester.load_time
    report.results, report.speech_time = tester.results, tester.speech_time
    _report_stages(report)
    return report


def _report_stages(report: RunReport) -> None:
    _say("seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in report.stages.items()))


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
