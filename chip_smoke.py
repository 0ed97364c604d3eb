"""Chip smoke of the PyTorch/CUDA port: the main decode path on one card.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

  1. card: name and power limit (nvidia-smi) and torch's device name;
  2. build: every CUDA kernel of `juicer_tpu_torch/csrc/`, one nvcc each,
     in parallel, with the build time and ptxas report;
  3. GMM kernel vs plain: the hand-written kernel against the plain
     PyTorch scorer `gmm_scores_dense` on the card, at the shapes of both
     decode waves below (16 and 132 utterances x the longest length,
     T = 23,328 and 192,456; D=39, 141 GMMs, 8 components), atol 1e-3 on
     scores of magnitude ~1e2; at each: kernel, plain and library-call
     (one matmul of [x^2 | x] with [V; M] + logsumexp) times over CUDA
     events, the kernel's bound (the larger of its float32 operations over
     the card's CUDA-core peak and its bytes over the memory rate) and the
     share of the bound it reaches;
  4. plain decode, the reference run: the 2k-word WSJ-order task
     (`scripts/_wsj_cache_2k`, its artifact built on first use) at the
     reference bench's operating point (beam 70 / end-beam 50 / maxHyps
     500, K=1024, E=1408), 8 sampled utterances of ~1000 frames tiled to a
     batch of 16, scored by the GMM kernel and decoded by the plain frame
     loop `TorchDecoder.run` (diagnostics on, the GMM kernel's launches
     counted around it; then one timed wave with diagnostics off, as the
     bench runs, without a further warm-up).
     Certified in-run: overflow 0/16, dead 0/16, and the traced-back
     words equal each utterance's generating transcript;
  5. frame-step kernel vs plain: the fused scan on the same (T, B, G)
     scores as the plain reference wave. The kernel hands back compact
     records (only those that landed, in (frame, slot) order, and the
     running count per frame): they equal `compact_records` of the plain
     planes, `expand_records` of them equals the plain planes, and the
     eight snapshots, the carry (`norm`, overflow, frontier) and the
     traced-back words and word-end frames are equal bit for bit, at the
     full-width wave; the same with `max_emit_hyps=0` (the TPU kernel's
     scope) on a short sentence, in one launch and in two calls with the
     carried state. The first differing field, frame, utterance and slot
     are printed on failure. The best-path walk (`path_walk_kernel`) on the
     fused state equals its plain version on a CPU copy, every header word
     and path row (`[fused walk]`: path rows, kernel, plain and bound ms).
     Also printed: records landed per frame and utterance (mean, peak) and
     the bytes a wave copies to the host on the fused route and on the
     routes that copy the arena;
  6. the main path through the kernels: launch counts of the three kernels
     are zeroed just before and read just after `BatchDecoder(dec)` (default
     `use_fused="auto"`) decodes the batch twice (features -> GMM kernel ->
     frame-step kernel -> best-path walk, one launch each a wave -> copy of
     the paths to the host -> words): the first call is certified as in 4,
     the second is timed,
     and its frames/s stand beside the plain loop's. Then, outside the
     counted run, the device's share of a wave (both kernels, no copy to
     the host and no traceback), the frame-step kernel's time per wave
     over CUDA events and its bound (the bytes it must move, counted from
     the shapes and the wave's measured candidates and active slots, over
     the memory rate), for the compact contract and, as the earlier
     row, for dense record planes;
  6b. a card full of utterances: the same 8 utterances tiled to B=132 (one
     block on every SM), launch counts zeroed before and read after one
     certified and one timed wave through `BatchDecoder` (one launch of each
     kernel a wave); the walk held to its plain version at B=132; every
     utterance's words, word-end frames and score must equal the B=16
     wave's; the kernel's ms a wave, the device-only and the entry
     point's frames/s at B=132 beside those at B=16, and the device wave
     over CUDA events beside its parts (GMM kernel, the scores' transpose
     to (T, B, G), frame-step kernel);
  7. parity: a short whole sentence (300 frames, sampled with seed 12; a
     cut utterance reaches no final state) decodes on the card and with
     device="cpu" from the same scores (words, word-end frames and the
     traceback record arrays equal), and from the plain CPU scorer's
     scores (words and word-end frames equal, records reported); its
     words must equal its transcript; `TorchDecoder.decode_scores` on the
     card gives the same result through one launch of the kernel;
  [20k] the reference bench's own task (`scripts/_wsj_cache_20k`: 7,870,751
     arcs, its artifact of 213,046,110 closure entries built in memory, no
     cache written), run after the 2k phases' state is released:
       - the build's seconds and the process's peak host RSS, the tables'
         bytes on the card and their upload seconds, the fused scope;
       - 8 utterances sampled with seed 11 at ~1000 frames, tiled to B=16
         and B=132; the GMM kernel against the plain scorer at both waves'
         shapes, as in 3;
       - `autotune_budgets` at margin 1.4 from `WSJ_POINT`'s budgets
         through the frame-step kernel on the 8 distinct utterances; the
         tuned budgets must decode every one without overflow to its
         transcript (a probe outside the kernel's scope raises);
       - the plain frame loop's B=16 wave as the reference, the kernel
         equal to it bit for bit as in 5 (the walk too, and at B=132 after
         the certification);
       - certification through `BatchDecoder` at B=16 and B=132 (overflow
         0, dead 0, transcripts exact, each B=132 result equal to its B=16
         result), launch counts of the three kernels zeroed before and
         read after each;
       - [mesh 20k] `BatchDecoder(dec, mesh=)` over replicas on the one
         card: (dev, dev) at B=16 (shares 8 + 8) and B=132 (66 + 66),
         (dev, dev, dev) at B=16 (6 + 5 + 5); each share's features scored
         by the GMM scorer of its device; launch counts zeroed before and
         read after the first call must be one of each kernel a share;
         every utterance equal to the single-device results bit for bit
         and certified; `memory_allocated` before and after the replicas
         are made (no growth: one decoder a device, the tables shared) and
         after the decode (less than half the tables' bytes more: no
         second copy); a second call's wall seconds beside the
         single-device call's (replicas on one card: not a scaling
         number); after [20k parity], the plain route over (dev, dev) on
         its sentence twice (shares 1 + 1), equal to
         `decode_scores(use_fused=False)`, no frame_step launch;
       - frame-step ms a wave at 20k beside 2k at both B, its bound; the
         entry point's and the device-only frames/s;
       - the streaming decoder on one utterance in chunks of 100 frames
         through the kernel: one launch a chunk, every partial emission a
         prefix of the final words, `finish()` equal to `decode_scores`;
       - card vs CPU parity on one short whole sentence (seed 12), as in 7;
  [mesh gloo 2k] after 7 (and [2k stream audio]), the multi-process demo
     (`python -m juicer_tpu_torch.parallel.multihost_demo 2 --task 2k
     --device cuda`): two `gloo` ranks on the card, each loading the 2k
     artifact from the cache the 2k phases wrote and decoding its
     round-robin share of the 8 seed-11 utterances as one `BatchDecoder`
     batch; each rank must launch each kernel once; every utterance's
     words, word-end frames and score must equal the main path's result
     in this process, and the all-reduced totals (words, frames,
     utterances) its sums; the demo's wall seconds and each rank's decode
     seconds printed;
  [variants] the configurations outside the frame-step kernel (float64, the
     exact histogram with a binding maxHyps (the peak of active slots
     without one), the sort merge, the sort
     merge with lattices), on the 2k task at `WSJ_POINT` with the sentence
     of 7 scored by the GMM kernel: "auto" raises on the card with
     `why_not_fused`'s reason; `run` on the card (the plain loop, ms a
     frame printed) equals the same decoder on the CPU in every plane
     (integers exactly, floats within 1e-9 in float64 and 1e-4 in
     float32); words and word-end frames equal, also through
     `decode_scores(use_fused=False)`; launch counts zeroed before and read
     after (gmm_logsumexp > 0, frame_step 0);
  [lattice] `decode_scores_lattice(use_fused=False)` on that sentence at 2k
     and on the seed-12 sentence at 20k ("auto" raises): the lattice's best
     path is the 1-best words at cost -(ac+lm) within 1e-3, and at 2k the
     lattice equals the CPU's (states, arcs, labels; weights within 1e-4);
     printed: frames, decode ms a frame, `build_lattice` seconds, states
     and arcs before and after `connect`, the bytes of the E- and F-wide
     lattice records copied to the host; launch counts as in [variants].
     Also in [20k]: gmm_logsumexp at the B=16 shape read five more times;
  [otf] on-the-fly composition at the 20k task (`scripts/wsj_otf.py`'s
     point `OTF_POINT`: beam 85 / end-beam 60 / maxHyps 800), run after
     the static 20k state is released; no kernel covers a decoder with a
     G, so the frame loop is the plain one (`use_fused=False`; "auto"
     raises with `why_not_fused`'s reason):
       - task: CL's artifact and G built in memory (`load_otf_task`; the
         counts 37,443 / 35,098 / 310,115 and 20,004 / 151,567 / 2 are
         checked), `anticipated_labels` seconds, the tables' bytes on the
         card;
       - gmm: the 8 seed-11 utterances (the static 20k point's) scored by
         the GMM kernel, held to the plain scorer as in 3;
       - autotune: `autotune_budgets(g_network=, margin=1.4,
         use_fused=False)` from K=4096 / E=8192, F=1024; the steps below
         decode at the tuned budgets;
       - main path: `BatchDecoder(use_fused=False)` over B=8 twice, launch
         counts zeroed before and read after (gmm_logsumexp one a wave,
         frame_step 0), certified (overflow 0/8, dead 0/8, transcripts
         exact); ms a frame step and frames/s at the entry point, and over
         20 frames the wall ms, kernel launches, kernel ms and the device's
         idle share a frame step (`profile_decode.plain_loop_profile`),
         beside the static 20k plain loop's of this call;
       - pushing: the same batch with `otf_pushing=True`, certified; its
         words equal plain OTF's; its un-normalised acoustic and LM scores
         within 8 float32 spacings at the utterance's |acoustic| (0.0625
         at the |acoustic| ~6.6e4 of this batch; the rounding of the
         cumulative normaliser, which pushing changes) and, decoded again
         in float64 beside plain OTF in float64, within 1e-6;
       - card = CPU: the seed-12 sentence in float32 and float64, every
         plane of `run` equal (floats within 0.0; else field, frame,
         utterance and slot are printed), words equal;
       - lattice: that sentence with `gen_lattice=True` as in [lattice];
       - stream: that sentence through `dec.stream(use_fused=False)` in
         chunks of 100 frames, `finish()` equal to the whole decode;
  [wsj bench 20k] at the end of [20k], on its task and artifact (no second
     build): `harness/wsj_bench`'s main path (`run`) at `WSJ_POINT`'s beams,
     the budgets tuned from K=1024 / E=1408 over the 8 seed-11 utterances
     of ~1000 frames: the tuned K and E and every utterance's words equal
     [20k]'s, overflow 0/8, dead 0/8, accuracy 1; `steady_bench` at B=8
     and B=16 on the kernel route, overflow 0; the float32 engine against
     the oracle `RefDecoder` on the two short seed-12 utterances
     (reported), then `--parity-only`: the float64 engine (the plain loop)
     against the oracle, words exact, scores within 1e-6 (its own oracle
     decodes, as the script's); launch counts zeroed before and read
     after;
  [wsj sweep 20k] after it: `harness/wsj_sweep` with `SWEEP_EASY` (rungs
     70,50,500 and 60,40,300 on the tracked models, tuned from K=1024 /
     E=1408: each must certify on the kernel route: overflow 0, dead 0,
     the bench wave's overflow 0; accuracy reported) and `SWEEP_HARD`
     (100,75,1200, free text, decode-side mismatch 1.5, the JAX sweep's
     start K=2048 / E=4096, 4 utterances of ~300 frames and a bench at
     B=4: its route and reason printed, expected the plain loop past the
     kernel's shared memory); one line a rung with
     K, E, accuracy, errors, peak, overflow, dead, steady frames/s and
     route; the seconds of each sweep;
  [wsj otf 20k] inside [otf]: its budgets are `harness/wsj_otf.tune`'s
     (the route named), its main path's accuracy is `wsj_otf`'s, the
     oracle `RefOtfDecoder` on one short held-out utterance (seed 12, ~150
     frames) must give the decoder's words, and `wsj_otf`'s steady bench
     (`steady_bench(g_network=)`) at B=8 on the main path's scores: the
     plain loop, overflow 0 in the timed wave;
  [bench otf] last: `harness/bench_otf --quick` on the card (the word-loop
     task composed on the fly, with and without pushing, B=8 x 128 frames,
     the plain loop): each distinct utterance certified, no frame_step
     launch; its frames/s are printed as a check that it runs (bound by
     the host at this size), not as a throughput;
  [toolchain 2k] after the 2k tables are released: the 2k CLG rebuilt on
     the host by the port's offline toolchain from the task's phones.lst,
     lex.dict and lm.arpa (`wsj_task.build_task`: `GramGen(NGRAM)`,
     `LexGen` with aux phones, the monophone `CDGen`, `build_clg`, each
     stage's states, arcs and seconds printed), held to clg.npz bit for bit
     (every array and scalar; a difference names the array and its first
     index); [cli 2k] writes its network text from it. The build is host
     work only: it runs in a child process (`python -m
     juicer_tpu_torch.harness.wsj_task --build 2k --networks clg --out`)
     started with the smoke, beside the card phases before this one, and
     the network it writes is held to clg.npz again here;
  [cli 2k] the decoder CLI (`juicer_tpu_torch.cli.juicer`, run in this
     process through `run`, which `main` is with an exit code) on the 2k
     task. The smoke writes the CLI's
     files into a temporary directory with its own writers (floats at
     round-trip precision): the CLG as AT&T text (the initial state's arcs
     first), symbol files (model names in, `Vocabulary` words out), the
     models as a text MMF (~t, ~s and ~h macros), the lexicon, HTK
     features, an input list and plain references. Three calls at
     `WSJ_POINT`:
       (a) `-batchSize 1 -outputFormat xmlf -writeBinaryFiles` on the
           first four seed-11 utterances and the seed-12 sentence: route
           line `frame_step kernel`, one launch of each kernel an
           utterance, words, word-end frames and scores equal to the
           library's (the main path's B=16 wave, [parity]'s sentence);
       (b) `-latticeDir -modelLevelOutput` on the sentence, reading (a)'s
           npz caches: route line `plain frame loop (gen_lattice: ...)`,
           no frame_step launch; the lattice file's best path equals
           (a)'s words;
       (c) `-loop -loopChunk 100` as a subprocess (`python -m
           juicer_tpu_torch.cli.juicer`), the sentence's float32 frames on
           stdin: its `final:` line equals (a)'s words and the `partial:`
           words are a prefix of them; the route line names the kernel;
  [cli ref 2k] (d) `-refCore` on the sentence, from (a)'s caches: route line
     `oracle token passing on the host`, launches gmm_logsumexp 1 and
     frame_step 0; words and word-end frames equal (a)'s (the kernel route)
     and the transcript; score, acoustic and LM within 16 float32 spacings
     of (a)'s (the oracle sums in float64 what the kernel sums in float32);
     the oracle's seconds and frames/s printed;
  [cli loop audio 2k] (e) `-loop -audioDevice - -loopChunk 100` as a
     subprocess, 300 frames of `wsj_task.sample_audio` (seed 13) as S16LE
     PCM on stdin: the `partial:` and `final:` words equal the library's,
     computed before the 2k tables are released (`[2k stream audio]`: the
     same PCM through `capture_features`, the streaming front end on the
     card, each chunk scored by the GMM kernel and fed to a
     `StreamingDecoder` of the CLI's configuration: one launch of each
     kernel a chunk); stderr names the kernel route and the front end on
     the card;
  [toolchain cli 2k] in [cli 2k]'s directory, the users' entry points end
     to end: `jtpu-gramgen-torch -gramType ngram`, `jtpu-lexgen-torch
     -silMonophone sil -pauseMonophone sp -outputAuxPhones`,
     `jtpu-cdgen-torch -cdType monophone -lexInSymsFName` and
     `jtpu-build-wfst-torch` (`python -m`, one child process each, in
     turn, started with the smoke, beside the card phases) on the 2k
     files; G, L, C and final.fsm read back with the JAX tools' counts
     (final.fsm 178,593 states and 1,605,301 arcs: the CLI route's CLG is
     not clg.npz's, as its C carries the aux self-loops twice and the text
     between the tools has three decimals). `jtpu-juicer-torch` decodes
     [cli 2k]'s utterances from final.fsm at `WSJ_POINT`, `-batchSize 1`:
     route `frame_step kernel`, one launch of each kernel an utterance,
     certified (overflow 0, dead 0, every utterance's words equal its
     transcript, `Word accuracy = 100.00%`). Then `jtpu-genwfstseqs-torch`
     on final.fsm (5 sequences over its input symbols), `jtpu-hmmgen-torch`
     on the MMF (H's states read back) and `jtpu-untie-torch` with a tied
     list of four logical names (the untied MMF read back: each logical
     model's means are its physical model's within the MMF writer's seven
     significant digits, the list sorted);
  [cli 20k] the slice's full-width path, after the [20k] task is released
     (its host artifact and tables: two in-memory builds may not fit):
       - files: the 20k CLG (7,870,751 arcs) as text, symbol files, the
         MMF, the lexicon, the 8 seed-11 utterances tiled to 16 as HTK
         files, the input list and references; the network read back from
         the text (`DecoderNetwork.from_files`) equals clg.npz in every
         array (a marker that differs is printed with the reason), and
         `AcousticModelSet.from_mmf` gives models.npz's `flat_params` and
         topology bit for bit;
       - the run: `-batchSize 16` at `WSJ_POINT` (`-mainBeam 70
         -phoneEndBeam 50 -wordEmitBeam 50 -maxHyps 500 -maxInsts 1024
         -expandBudget 1408`), `-outputFormat verbose -refFName
         -removeSentMarks -logFName`; certified: `Word accuracy =
         100.00%`, no budget-overflow warning, route line `frame_step
         kernel` (also in the log); launch counts zeroed before and read
         after the run: gmm_logsumexp 16 (one an utterance), frame_step 1;
       - equality: every utterance's words, word-end frames and score
         equal the [20k] B=16 results bit for bit; gmm_logsumexp gives
         each utterance scored alone the bits of its rows in the whole
         wave;
       - printed: the seconds of each stage (text write, FSM parse,
         network, models, artifact, tables, features, decode, output),
         the CLI's frames/s beside the library entry point's of this
         call, the verbose output's RT factor;
  [cli audio 20k] in [cli 20k]'s directory, the slice's path at full
     width: 16 wav files of `wsj_task.sample_audio` (seed 21) whose MFCC
     lengths are [20k]'s T twice over, a two-class base-class file and an
     MLLRMEAN set of two transforms from the same seed. The library side
     runs at the end of [20k] on its decoder (`[20k audio]`): the batched
     front end on the card (`frontend.mfcc_batch`) within 1e-4 of `mfcc`
     of each utterance on the CPU; `apply_mllr_means` on the card, its
     float64 means and flat parameters within 1e-12 (relative above 1) of
     the CPU's; each utterance scored by the GMM kernel on the adapted
     parameters, edge-padded, one `BatchDecoder` wave. The CLI, one call
     with `-inputFormat factory -mllrXformFile -regClassFile -batchSize 16`
     at `WSJ_POINT`: route `frame_step kernel`, `front end: MFCC ... on
     cuda`, launches gmm_logsumexp 16 and frame_step 1, every utterance's
     words, word-end frames and score equal to the library's bit for bit,
     its overflow warnings as many as the library's overflowing
     utterances (the audio's flat likelihoods fill the bench's budgets;
     counted, not hidden); the seconds of every stage printed (front end,
     mllr, artifact, decode among them);
  [toolchain 20k] before [otf]: the 20k CL rebuilt on the host by the
     port's toolchain (`wsj_task.build_task`: `LexGen` with aux phones,
     `minimize(determinize(arcsort(L)))`, the monophone `CDGen`,
     `compose(C, closure(arcsort(L)))`), held to cl.npz bit for bit;
  [cli otf] after [otf]: [toolchain 20k]'s CL and G (`arpa_grammar` of
     `lm.arpa`) written as text and read back equal to cl.npz and to G
     (the network's arrays and `GNetwork`'s); the G of [otf] and of this
     phase is the port's grammar generator's, so the pair the CLI decodes
     is the port's toolchain's from end to end; the CLI with
     `-gramFsmFName`, `-batchSize 8` at
     `OTF_POINT`'s beams and [otf]'s tuned budgets: route line `plain
     frame loop (on-the-fly composition: ...)`, certified, launches
     gmm_logsumexp 8 and frame_step 0, every utterance equal to [otf]'s
     main path;
  [gramgen 20k] `jtpu-gramgen-torch -gramType ngram` (its `main`) on the 20k
     lex.dict and lm.arpa: its G read back from the text equals [cli
     otf]'s `arpa_grammar` (the G of [otf]) arc for arc, labels and states
     exactly, weights within the text's three decimals;
  [scale 1M] after [bench otf]: `harness/scale_bench` at its full size: the
     random CLG-shaped network of 1,000,000 arcs, `make_models(2000)` (6,000
     GMMs of 8 components, D=39) and the artifact by the native closure
     (seconds, closure entries, largest fan-out, the tables' bytes on the
     card); B=1 at the script's defaults K=8192 / E=32768 (`decode_scores`
     twice, the plain loop, its reason printed, no frame_step launch);
     `--batch 8` at K=768 / E=1024 through `frame_step` (first and steady
     wave, two launches, overflow reported: the budgets bind by design),
     the same wave held bit for bit to the plain loop (`hold_to_plain`),
     the kernel's ms against `frame_step_bound`; its first utterance
     through `decode_scores` (one launch) equal to the plain loop's; K=1024 / E=1408 refused by
     `why_not_fused` at G=6,000 (shared memory); `gmm_logsumexp` at G=6,000
     on 8 x 500 frames of N(0, 1) features against the plain scorer, as in
     3, beside [gmm] B=16's G=141 reading;
  [pipeline scale] `harness/pipeline_scale` at 200 and 1000 words (host):
     each machine's arcs equal `PIPELINE_ARCS`, each stage's seconds;
  [profile step] `harness/profile_step` at B=16 x 200 frames, one timed
     iteration: the full wave on the plain loop and through one frame_step
     launch (best finals equal bit for bit; launches 0 and 2), the three
     ablations on the plain loop, the sort calls a frame step;
  [profile otf step] `harness/profile_otf_step` on [otf]'s pair (kept from
     that phase, not built again), 8 utterances of ~200 frames, one timed
     wave a line (full, no_g_advance, static_cl): the plain loop on every
     line, one GMM launch an utterance;
  [pallas probe] `harness/pallas_probe`: the nine probes through the three
     kernels of `csrc/probe_patterns.cu`, each equal to its plain version
     (exactly for D-I, within 1e-5 relative for A-C); the launches of each
     kernel over the tool's run; per probe kernel, plain and library ms and
     the bound;
  [graft entry] `graft_entry.entry` on the card (one launch of each kernel)
     against `entry(device="cpu")` on a synthesised utterance, best finals
     within 1e-3; `dryrun_multichip(2)` over two replicas on the card;
  8. result: a `kernels` JSON line (four kernels: gmm_logsumexp and
     frame_step with the 20k fields, path_walk (launches, ms, plain_ms,
     bound_ms at B=16, B=132 and 20k), the OTF path's launches, the CLI
     phases' launches, the mesh's (`launches_mesh`), the gloo ranks'
     (`launches_gloo`) and the tools' (`launches_wsj_bench`,
     `launches_wsj_sweep`, `launches_wsj_otf`, `launches_bench_otf`,
     `launches_scale_b1`, `launches_scale_b8`, `launches_profile_step`,
     `launches_profile_otf_step`, `launches_graft_entry`,
     `launches_graft_dryrun`; gmm_logsumexp also the G=6,000 reading,
     frame_step the steady benches' frames/s, the sweep's routes and the
     G=6,000 wave's ms and bound), and probe_patterns (its numbers summed
     over the nine probes, each probe's under "probes")), the seconds of
     each phase, the card line, and last {"ok": true, "device":
     {"platform": "gpu", "kind": ..., "count": 1}}.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores
# (no tensor cores), HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
GMM_ATOL = 1e-3
B2 = 132  # the wide wave: the same utterances tiled to one block an SM
STREAM_CHUNK = 100  # frames a feed of the streaming decoder
AUDIO_SEED = 21  # [cli audio 20k]: the audio and the MLLR transforms
LOOP_SEED, LOOP_FRAMES = 13, 300  # [cli loop audio 2k]'s audio
FRONT_ATOL = 1e-4  # the batched front end on the card against `mfcc` on the CPU
PARAM_TOL = 1e-12  # adapted float64 parameters, card against CPU, relative above 1


CHILDREN = []  # the child processes `run_module` starts; `clean_up` ends any left
TEMP_DIRS = []  # directories `clean_up` removes


def run_module(argv, timeout: float):
    """`python -m argv` from the repo's root in a child process: (exit code,
    its standard output and error, seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    CHILDREN.append(proc)
    out, _ = proc.communicate(timeout=timeout)
    return proc.returncode, out, time.perf_counter() - t0


def clean_up():
    """Kill the child processes still running and remove the temporary
    directories."""
    import shutil

    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    for d in TEMP_DIRS:
        shutil.rmtree(d, ignore_errors=True)


def start_host_builds():
    """Start the two 2k CLG builds, host work only, in child processes now,
    so that they run beside the card phases before the two phases that
    wait for them: [toolchain 2k]'s `wsj_task --build 2k --networks clg`,
    and [toolchain cli 2k]'s `jtpu-gramgen-torch`, `jtpu-lexgen-torch`,
    `jtpu-cdgen-torch` and `jtpu-build-wfst-torch` in turn. Both write into
    a temporary directory. Returns (that directory, the future of the
    first build's `run_module` result, the future of the tools' list of
    (tool, exit code, output, seconds), which ends at a failing tool)."""
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from juicer_tpu_torch.harness import wsj_task

    cache = wsj_task.task_dir("2k")
    tools = tempfile.mkdtemp(prefix="smoke_tools_")
    TEMP_DIRS.append(tools)

    def j(name):
        return os.path.join(tools, name)

    def outs(prefix):
        return ["-fsmFName", j(f"{prefix}.fsm"), "-inSymsFName", j(f"{prefix}.insyms"),
                "-outSymsFName", j(f"{prefix}.outsyms")]

    marks = ["-sentStartWord", "<s>", "-sentEndWord", "</s>"]
    phones = ["-monoListFName", os.path.join(cache, "phones.lst"), "-silMonophone", "sil",
              "-pauseMonophone", "sp"]
    steps = [("gramgen", ["-lexFName", os.path.join(cache, "lex.dict"), *marks, "-gramType",
                          "ngram", "-lmFName", os.path.join(cache, "lm.arpa"), *outs("g")]),
             ("lexgen", [*phones, "-lexFName", os.path.join(cache, "lex.dict"), *marks,
                         "-outputAuxPhones", *outs("l")]),
             ("cdgen", ["-cdType", "monophone", *phones, "-lexInSymsFName", j("l.insyms"),
                        *outs("c")]),
             ("build-wfst", [j("g.fsm"), j("l.fsm"), j("c.fsm")])]

    def cli_tools():
        done = []
        for name, argv in steps:
            done.append((name, *run_module(
                [f"juicer_tpu_torch.cli.{name.replace('-', '_')}", *argv], 900)))
            if done[-1][1] != 0:
                break
        return done

    pool = ThreadPoolExecutor(max_workers=2)
    clg = pool.submit(run_module, ["juicer_tpu_torch.harness.wsj_task", "--build", "2k",
                                   "--networks", "clg", "--out", tools], 900)
    cli = pool.submit(cli_tools)
    pool.shutdown(wait=False)
    return tools, clg, cli


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after a warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tile_features(utts, B, dev):
    """(B, Tmax, D) features on the card, utterance i % len(utts) in row i,
    edge-padded like the bench, with the true lengths and Tmax."""
    import torch

    lengths_u = [f.shape[0] for _, f in utts]
    Tmax = max(lengths_u)
    feats = torch.stack([
        torch.as_tensor(f).index_select(0, torch.arange(Tmax).clamp(max=f.shape[0] - 1))
        for _, f in (utts[i % len(utts)] for i in range(B))
    ]).to(dev)
    return feats, [lengths_u[i % len(utts)] for i in range(B)], Tmax


def gmm_phase(scorer, xx, what, card):
    """The GMM kernel against the plain scorer and the library call on
    (T, D) features: max |err|, ms of each, the bound and its share."""
    import torch

    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.ops.gmm import gmm_scores_dense

    T, D = xx.shape
    G, C = scorer.n_gmms, scorer.mask.shape[1]
    # the library yardstick: one matmul of [x^2 | x] with [V; M] and one
    # logsumexp over the components, in component-major column order
    VM = torch.cat([scorer.V, scorer.M], dim=0).view(2 * D, G, C).transpose(1, 2)
    VM = VM.reshape(2 * D, C * G)
    b_lib = torch.where(scorer.mask, scorer.b.view(G, C), -1e30).t().contiguous()
    ker = gmm_cuda.gmm_logsumexp(xx, scorer.W, scorer.b_packed, G)
    plain = gmm_scores_dense(xx, scorer.V, scorer.M, scorer.b, scorer.mask)
    torch.cuda.synchronize()
    if not torch.isfinite(ker).all():
        raise RuntimeError(f"gmm_logsumexp produced non-finite scores at {what}")

    def library():
        return torch.logsumexp(
            (torch.cat([xx * xx, xx], dim=1) @ VM).view(T, C, G) + b_lib, dim=1)

    err = float((ker - plain).abs().max())
    lib_err = float((library() - plain).abs().max())
    print(f"[gmm] {what}: kernel vs plain max |err| {err:.3e} (atol {GMM_ATOL}, "
          f"|score| up to {float(plain.abs().max()):.1f}); library vs plain "
          f"{lib_err:.3e}", flush=True)
    if not err <= GMM_ATOL:
        raise RuntimeError(f"gmm_logsumexp disagrees with gmm_scores_dense at {what}: {err}")
    del ker, plain
    n0 = gmm_cuda.counter.launches
    ms = cuda_ms(lambda: gmm_cuda.gmm_logsumexp(xx, scorer.W, scorer.b_packed, G), 20)
    if gmm_cuda.counter.launches - n0 != 21:
        raise RuntimeError("gmm_logsumexp launch counter did not count its launches")
    plain_ms = cuda_ms(
        lambda: gmm_scores_dense(xx, scorer.V, scorer.M, scorer.b, scorer.mask), 20)
    library_ms = cuda_ms(library, 20)
    # the function's own work: every real (frame, GMM, component) over
    # 2D inputs; each input byte read once, each output byte written once
    flops = 2.0 * T * G * C * 2 * D
    nbytes = 4.0 * (xx.numel() + 2 * D * G * C + G * C + T * G)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[gmm] {what}: T={T} D={D} G={G} C={C}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB), "
          f"{100 * bound_ms / ms:.1f} % of the bound | {card}", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def frames_of(r):
    return [h.end_frame for h in r.word_hyps]


def same_result(a, b) -> bool:
    return a.words == b.words and frames_of(a) == frames_of(b) and a.score == b.score


def certify(results, what, utts, labels, markers):
    """Overflow 0, dead 0 and every utterance's words equal to the
    transcript it was generated from (row i holds utterance i % len(utts))."""
    B = len(results)
    n_ov = sum(r.overflow for r in results)
    dead = sum(r.empty for r in results)
    wrong = [i for i, r in enumerate(results)
             if [w for w in r.words if w not in markers]
             != [labels[w] for w in utts[i % len(utts)][0]]]
    print(f"[{what}] overflow {n_ov}/{B}, dead {dead}/{B}, transcript mismatches "
          f"{wrong}; peak active {max(r.max_active for r in results)}, peak "
          f"candidates {max(r.max_cand for r in results)}", flush=True)
    if n_ov or dead or wrong:
        raise RuntimeError(f"{what}: certification failed at the operating point")


def require_equal(what, got, want):
    from juicer_tpu_torch.decoder.fused_scan import state_differences

    diffs = state_differences(got, want)
    for line in diffs:
        print(f"[{what}] DIFFERS {line}", flush=True)
    if diffs:
        raise RuntimeError(f"{what}: frame_step disagrees with the plain version")


def hold_to_plain(what, dec, fs, scores_tbg, plain_state, plain_results, lengths):
    """The fused scan on the plain wave's scores, bit for bit: compact
    records equal `compact_records` of the plain planes and expand to
    them, snapshots and carry equal, the best-path walk equal to its plain
    version (`hold_walk`), tracebacks equal. Returns the fused state, the
    largest float difference of the expanded planes (0) and the walk's
    numbers."""
    import torch

    from juicer_tpu_torch.decoder.fused_scan import (REC_NAMES, assemble_results,
                                                     compact_records, expand_records)

    fused_state = fs(scores_tbg)
    torch.cuda.synchronize()
    require_equal(what, fused_state, (plain_state[0], compact_records(plain_state[1])))
    expanded = expand_records(fused_state[1], dec.K)
    for k in REC_NAMES:
        if not torch.equal(expanded[k], plain_state[1][k]):
            raise RuntimeError(f"{what}: expand_records differs from the plain plane {k}")
    float_err = max(float((expanded[k] - plain_state[1][k]).abs().max())
                    for k in ("rec_score", "rec_ac", "rec_lm", "bf_score", "bf_ac", "bf_lm"))
    del expanded
    walk = hold_walk(what, fs, fused_state, lengths)
    results = assemble_results(dec, fs, *fused_state, lengths)
    for i, (a, b) in enumerate(zip(results, plain_results)):
        if not same_result(a, b):
            raise RuntimeError(f"{what}: fused and plain tracebacks differ for utterance {i}")
    return fused_state, float_err, walk


def hold_walk(what, fs, state, lengths):
    """The best-path walk on the card (`fused_scan.walk_paths`, kernel
    `path_walk_kernel`) against its plain version on a CPU copy of the same
    fused state: every header word (best final, overflow, stats, span
    counters, path length and status) and every path row equal, the
    status 0 everywhere. Returns the walk's numbers for the kernels line:
    path rows walked, kernel ms over CUDA events, plain ms, bound ms and
    the bytes copied to the host (`read_paths`)."""
    import torch

    from juicer_tpu_torch.decoder import fused_scan

    carry, ys = state
    T, B = ys["rec_count"].shape
    n_max = int(ys["rec_count"][-1].max())
    ys_cpu = {k: (v[:, :n_max] if k == "records" else v).cpu() for k, v in ys.items()}
    bf_cpu = {f: v.cpu() for f, v in carry["best_final"].items()}
    packed = fused_scan.walk_paths(fs, carry, ys, lengths)
    got = packed.cpu()
    t0 = time.perf_counter()
    want = fused_scan.walk_paths_plain(ys_cpu, bf_cpu, carry["overflow"].cpu(),
                                       fs.rec0_rows.cpu(), lengths, fs.dec.K)
    plain_ms = (time.perf_counter() - t0) * 1e3
    n_head, W = B * fused_scan.HEAD_WORDS, fused_scan.HEAD_WORDS
    head, head_want = got[:n_head].view(B, W), want[:n_head].view(B, W)
    for b in range(B):
        for i, name in enumerate(fused_scan.HEAD):
            if head[b, i] != head_want[b, i]:
                print(f"[{what} walk] DIFFERS header {name} of utterance {b}: "
                      f"{int(head[b, i])} against {int(head_want[b, i])}", flush=True)
    if not torch.equal(head, head_want):
        raise RuntimeError(f"{what}: the walk's headers differ from the plain version")
    if int(head[:, fused_scan.H["status"]].abs().sum()):
        raise RuntimeError(f"{what}: a walk did not reach the path's first record")
    rows, rows_want = got[n_head:].view(T + 1, B, 8), want[n_head:].view(T + 1, B, 8)
    lens = head[:, fused_scan.H["len"]].tolist()
    for b, n in enumerate(lens):
        if not torch.equal(rows[:n, b], rows_want[:n, b]):
            r = int((rows[:n, b] != rows_want[:n, b]).any(1).nonzero()[0])
            raise RuntimeError(f"{what}: the walk's row {r} of utterance {b} differs: "
                               f"{rows[r, b].tolist()} against {rows_want[r, b].tolist()}")
    _, _, nbytes = fused_scan.read_paths(packed, B, T)
    ms = cuda_ms(lambda: fused_scan.walk_paths(fs, carry, ys, lengths), 5)
    # what the walk must move: n_active and n_cand of every frame (the span
    # counters), a 32-byte row read and written a path row, the headers
    path_rows = sum(lens)
    bound_ms = (8.0 * T * B + 64.0 * path_rows + 4.0 * n_head) / PEAK_BYTES * 1e3
    print(f"[{what} walk] {B} utterances, {path_rows} path rows (longest {max(lens)}): "
          f"headers and rows equal to the plain version; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms on the host, bound {bound_ms:.6f} ms (bytes; a chain of "
          f"dependent loads a path); {nbytes} bytes copied to the host", flush=True)
    return dict(rows=path_rows, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bytes=nbytes)


def frame_step_bound(dec, B, Tmax, n_scores, n_cand, n_active, n_rec):
    """The frame-step kernel's bound for one wave: every input read once
    (scores, the carry, the 32-byte metadata row of each active slot, the
    four entry-table columns of each candidate), every output written once
    (the landed records, the count and the eight snapshots per frame);
    with the earlier contract's dense record planes as a second number.
    Returns (bound ms, bound_by, bytes, operations, dense bound ms)."""
    K, S = dec.K, dec.S
    carry_bytes = B * (K * (8 + S * 16) + 17)
    touched = 4.0 * n_scores + 2 * carry_bytes + 24.0 * n_cand
    nbytes = touched + 32.0 * n_active + 32.0 * n_rec + 4.0 * Tmax * B * 9
    dense = (touched + 48.0 * n_active + 4.0 * Tmax * B * (7 * K + 8)) / PEAK_BYTES * 1e3
    # per active slot and frame: S*S adds and compares of the propagation
    # and a few per state after it; per candidate a handful
    ops = float(n_active) * (2 * S * S + 12 * S) + 20.0 * n_cand
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            nbytes, ops, dense)


def wave_counts(ys):
    """Candidates, active slot-frames and landed records of a fused wave."""
    return (int(ys["n_cand"].sum()), int(ys["n_active"].sum()),
            int(ys["rec_count"][-1].sum()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        from juicer_tpu_torch import _cuda_build
        from juicer_tpu_torch.decoder import fused_scan
        from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch
        from juicer_tpu_torch.decoder.fused_scan import (
            FusedDecodeScan, compact_records, concat_records)
        from juicer_tpu_torch.harness import card_line, wsj_task
        from juicer_tpu_torch.ops import gmm_cuda
        from juicer_tpu_torch.ops.gmm import make_gmm_scorer
        from juicer_tpu_torch.parallel.mesh import BatchDecoder
    except ImportError as e:
        print(f"chip_smoke: the juicer_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        t_phase = now

    # ---- 1. card ------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| {kind} | devices {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda", 0)

    host_builds = start_host_builds()

    # ---- 2. build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = _cuda_build.build_all()
    print(f"[build] {len(_cuda_build.SOURCES)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, rep in reports.items():
        entry = ""
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                entry = line
            # frame_step is compiled per HMM state count and for staged or
            # unstaged HMM tables; S=5, staged, is the task's
            if name == "frame_step" and "ILi5ELb1E" not in entry:
                continue
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)
    phase_done("build")

    # ---- task and the main path's inputs --------------------------------
    task = wsj_task.load_task("2k")
    p = wsj_task.WSJ_POINT
    models = task.models
    params = models.flat_params()
    G, D = params.n_gmms, params.vec_size
    utts = wsj_task.sample_utterances(task.cache, models, n_utts=p["n_utts"],
                                      target_frames=p["frames"], seed=11)
    B = p["batch"]
    feats, lengths, Tmax = tile_features(utts, B, dev)
    print(f"[task] {len(utts)} utterances T={[f.shape[0] for _, f in utts]}, batch "
          f"{B} x {Tmax}", flush=True)
    phase_done("2k task")

    # ---- 3. GMM kernel vs plain, at both waves' shapes -----------------------
    scorer = make_gmm_scorer(params, device="cuda")
    x = feats.reshape(B * Tmax, D).contiguous()
    x2 = x.view(B, Tmax, D)[torch.arange(B2, device=dev) % B].reshape(B2 * Tmax, D)
    gmm16 = gmm_phase(scorer, x, f"B={B}", card)
    gmm132 = gmm_phase(scorer, x2, f"B={B2}", card)
    phase_done("3 gmm")

    # ---- 4. plain decode: the reference run ----------------------------------
    art = task.artifact
    cfg = wsj_task.decoder_config(p, emit_diagnostics=True)
    dec = TorchDecoder(art, cfg, device="cuda")
    fast = TorchDecoder(art, wsj_task.decoder_config(p, emit_diagnostics=False),
                        device="cuda")
    labels, markers = wsj_task.word_labels(task.cache)
    print(f"[decode] K={dec.K} E={dec.E} F={dec.F}, beams {p['beam']}/"
          f"{p['end_beam']}/{p['maxhyps']}", flush=True)

    # the plain reference wave: diagnostics on, traceback of every utterance
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    scores = scorer(x).view(B, Tmax, G)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_state = dec.run(scores)
    torch.cuda.synchronize()
    t_plain_diag = time.perf_counter() - t0
    plain_launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if plain_launches[0] == 0 or plain_launches[1] != 0:
        raise RuntimeError(f"the plain path launched gmm_logsumexp, frame_step "
                           f"{plain_launches} times; expected > 0 and 0")
    host = host_batch(*plain_state)
    plain_results = [dec.traceback(host, b, Tmax, true_T=lengths[b]) for b in range(B)]
    del host
    certify(plain_results, "plain", utts, labels, markers)
    # the plain bench wave: GMM kernel + frame loop, diagnostics off (the
    # wave above was its warm-up)
    t0 = time.perf_counter()
    carry, _, _ = fast.run(scorer(x).view(B, Tmax, G))
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
        raise RuntimeError("plain bench wave overflowed or died")
    fps_plain = B * Tmax / t_plain
    print(f"[plain] reference wave (diagnostics on) {t_plain_diag:.3f}s, launches: "
          f"gmm_logsumexp {plain_launches[0]}, frame_step {plain_launches[1]}; timed wave: "
          f"{B} x {Tmax} frames in {t_plain:.3f}s = {fps_plain:.1f} frames/s (GMM "
          f"kernel + plain frame loop, diagnostics off, one wave) | {card}", flush=True)
    del fast
    phase_done("4 plain")

    # ---- 5. frame-step kernel vs plain ---------------------------------------
    fs = FusedDecodeScan(dec, B)
    print(f"[fused] one block per utterance: {B} blocks of {fs.threads} threads, "
          f"{fused_scan.smem_bytes(**fs.dims)} bytes of dynamic shared memory each "
          f"(hash table of {fs.dims['HT']})", flush=True)
    scores_tbg = scores.transpose(0, 1).contiguous()
    fused_state, float_err, walk16 = hold_to_plain("fused", dec, fs, scores_tbg, plain_state,
                                                   plain_results, lengths)
    print(f"[fused] full-width wave {B} x {Tmax} at {p['beam']}/{p['end_beam']}/"
          f"{p['maxhyps']}: compact records, their expansion, 8 snapshots, carry, words "
          f"and word-end frames equal to the plain version (max |float diff| {float_err})",
          flush=True)
    n_cand_sum, n_active_sum, n_rec_sum = wave_counts(fused_state[1])
    count = fused_state[1]["rec_count"]
    per_frame = torch.diff(count, dim=0, prepend=torch.zeros_like(count[:1]))
    host = host_batch(*fused_state, fs.rec0)
    carry_h, ys_h, rec0_h = host
    host_bytes = (sum(v.nbytes for v in ys_h.values()) + sum(v.nbytes for v in rec0_h.values())
                  + sum(v.nbytes for v in carry_h["best_final"].values())
                  + carry_h["overflow"].nbytes)
    dense_bytes = 4 * Tmax * B * (7 * dec.K + 8)
    print(f"[records] {n_rec_sum} records landed in {B} x {Tmax} frames: "
          f"{n_rec_sum / (B * Tmax):.3f} a frame and utterance (peak "
          f"{int(per_frame.max())} in one frame), {32 * n_rec_sum / 1e6:.2f} MB of the "
          f"{fused_state[1]['records'].numel() * 4 / 1e6:.1f} MB arena written; a wave "
          f"copies {walk16['bytes'] / 1e6:.4f} MB to the host on the fused route (the walked "
          f"paths), {host_bytes / 1e6:.3f} MB on the routes that copy the arena (dense "
          f"planes: {dense_bytes / 1e6:.1f} MB)", flush=True)
    del host, carry_h, ys_h, rec0_h, count, per_frame
    del plain_state, fused_state

    # the TPU kernel's scope (no histogram) on a short whole sentence, in one
    # launch and in two calls with the carried state
    words_s, xs = wsj_task.sample_utterances(
        task.cache, models, n_utts=2, target_frames=250, seed=12)[1]
    xs = torch.as_tensor(xs)
    sc_card = scorer(xs.to(dev))
    Ts = sc_card.shape[0]
    dec0 = TorchDecoder(art, wsj_task.decoder_config(dict(p, maxhyps=0)), device="cuda")
    sc3 = sc_card[:, None, :].expand(-1, 3, -1).contiguous()
    fs0 = FusedDecodeScan(dec0, 3)
    whole = fs0(sc3)
    c0, y0, _ = dec0.run(sc3.transpose(0, 1))
    y0 = compact_records(y0)
    require_equal("fused maxhyps=0", whole, (c0, y0))
    half = Ts // 2
    first = fs0(sc3[:half])
    second = fs0(sc3[half:], carry=first[0], t0=half)
    joined = concat_records([first[1], second[1]])
    require_equal("fused two calls", (second[0], joined), whole)
    print(f"[fused] max_emit_hyps=0, {Ts} frames x 3: equal to the plain version whole "
          f"and in two calls of {half} and {Ts - half} frames with the carried state "
          f"(overflow {int(whole[0]['overflow'].sum())}/3)", flush=True)
    del whole, first, second, joined, c0, y0, dec0, fs0, sc3
    phase_done("5 fused vs plain")

    # ---- 6. the main path through the kernels ---------------------------------
    bd = BatchDecoder(dec)
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    fused_scan.walk_counter.launches = 0
    t0 = time.perf_counter()
    results = bd.decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    t_cert = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = bd.decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    t_entry = time.perf_counter() - t0
    launches = gmm_cuda.counter.launches
    fs_launches = fused_scan.counter.launches
    walk_launches = fused_scan.walk_counter.launches
    if launches == 0:
        raise RuntimeError("the main path did not launch gmm_logsumexp")
    if fs_launches == 0:
        raise RuntimeError("the main path did not launch frame_step")
    if walk_launches != 2:
        raise RuntimeError(f"two waves launched path_walk {walk_launches} times; expected "
                           f"one a wave")
    certify(results, "main path", utts, labels, markers)
    for i, (a, b) in enumerate(zip(again, results)):
        if a.words != b.words or a.score != b.score or a.overflow:
            raise RuntimeError(f"the timed main-path wave differs for utterance {i}")
    fps = B * Tmax / t_entry
    print(f"[main path] BatchDecoder (fused route), two waves; launches: gmm_logsumexp "
          f"{launches}, frame_step {fs_launches}, path_walk {walk_launches}; first wave "
          f"{t_cert:.3f}s", flush=True)
    print(f"[main path] timed wave through BatchDecoder: {B} x {Tmax} frames in "
          f"{t_entry:.4f}s = {fps:.1f} frames/s (GMM kernel + frame-step kernel + walk of "
          f"the best paths + copy of the paths to the host + words of {B} utterances) beside "
          f"{fps_plain:.1f} frames/s of the plain loop (no copy, no traceback) | {card}",
          flush=True)
    results16 = results
    del again

    # the device's share of that wave, outside the counted run: both kernels,
    # the records left on the card
    def device_wave():
        return fs(scorer(x).view(B, Tmax, G).transpose(0, 1).contiguous())

    device_wave()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = device_wave()
    torch.cuda.synchronize()
    t_wave = time.perf_counter() - t0
    if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
        raise RuntimeError("fused device wave overflowed or died")
    fps_device = B * Tmax / t_wave
    print(f"[main path] device only (no copy to the host, no traceback): {B} x {Tmax} "
          f"frames in {t_wave:.4f}s = {fps_device:.1f} frames/s | {card}", flush=True)

    # the kernel alone, and its bound
    fs_ms = cuda_ms(lambda: fs(scores_tbg), 3)
    fs_bound, fs_bound_by, fs_bytes, fs_ops, dense_bound = frame_step_bound(
        dec, B, Tmax, scores_tbg.numel(), n_cand_sum, n_active_sum, n_rec_sum)
    print(f"[frame_step] {B} x {Tmax} frames: kernel {fs_ms:.3f} ms a wave "
          f"({fs_ms * 1e3 / Tmax:.2f} us a frame), plain loop {t_plain_diag * 1e3:.1f} ms, "
          f"bound {fs_bound:.4f} ms ({fs_bound_by}: {fs_bytes / 1e6:.1f} MB, {fs_ops / 1e9:.3f} "
          f"G operations over {n_active_sum} active slot-frames of {Tmax * B * dec.K}; with "
          f"dense record planes the bound was {dense_bound:.4f} ms; the kernel sits at the "
          f"latency of its dependent stages with {B} of 132 SMs busy, not at this bound) "
          f"| {card}", flush=True)
    phase_done("6 main path")

    # ---- 6b. a card full of utterances: one block on every SM ----------------
    lengths2 = [lengths[i % B] for i in range(B2)]
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    fused_scan.walk_counter.launches = 0
    t0 = time.perf_counter()
    results2 = bd.decode_scores_batch(scorer(x2).view(B2, Tmax, G), lengths2)
    t_cert2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    again2 = bd.decode_scores_batch(scorer(x2).view(B2, Tmax, G), lengths2)
    t_entry2 = time.perf_counter() - t0
    launches2 = (gmm_cuda.counter.launches, fused_scan.counter.launches,
                 fused_scan.walk_counter.launches)
    if launches2 != (2, 2, 2):
        raise RuntimeError(f"B={B2}: two waves launched gmm_logsumexp, frame_step, path_walk "
                           f"{launches2} times; expected one each a wave")
    certify(results2, f"B={B2}", utts, labels, markers)
    for i, (a, c) in enumerate(zip(results2, again2)):
        ref = results16[i % B]
        for r in (a, c):
            if not same_result(r, ref) or r.overflow:
                raise RuntimeError(f"B={B2}: utterance {i} differs from the B={B} wave")
    del results2, again2, results16
    fs2 = bd._fs[dec.device, B2]
    scores2 = scorer(x2).view(B2, Tmax, G)
    tr_ms2 = cuda_ms(lambda: scores2.transpose(0, 1).contiguous(), 3)
    scores2_tbg = scores2.transpose(0, 1).contiguous()
    fs_ms2 = cuda_ms(lambda: fs2(scores2_tbg), 3)
    walk132 = hold_walk(f"B={B2}", fs2, fs2(scores2_tbg), lengths2)
    del scores2, scores2_tbg

    def device_wave2():
        return fs2(scorer(x2).view(B2, Tmax, G).transpose(0, 1).contiguous())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, _ = device_wave2()
    torch.cuda.synchronize()
    t_wave2 = time.perf_counter() - t0
    if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
        raise RuntimeError(f"B={B2}: fused device wave overflowed or died")
    wave_ms2 = cuda_ms(device_wave2, 3)
    fps2, fps_device2 = B2 * Tmax / t_entry2, B2 * Tmax / t_wave2
    print(f"[B={B2}] {len(utts)} utterances tiled to {B2} x {Tmax} frames, one block an SM: "
          f"every utterance's words, word-end frames and score equal the B={B} wave's; "
          f"launches of two waves: gmm_logsumexp {launches2[0]}, frame_step {launches2[1]}, "
          f"path_walk {launches2[2]}; first wave {t_cert2:.3f}s", flush=True)
    print(f"[B={B2}] frame_step {fs_ms2:.3f} ms a wave ({fs_ms2 * 1e3 / Tmax:.2f} us a frame "
          f"of {B2}) beside {fs_ms:.3f} ms at B={B} ({fs_ms2 / fs_ms:.2f}x the time for "
          f"{B2 / B:.2f}x the utterances) | {card}", flush=True)
    print(f"[B={B2}] entry point {fps2:.1f} frames/s (wave {t_entry2:.4f}s), device only "
          f"{fps_device2:.1f} frames/s (wave {t_wave2:.4f}s); at B={B}: entry point "
          f"{fps:.1f}, device only {fps_device:.1f} frames/s | {card}", flush=True)
    print(f"[B={B2}] device wave {wave_ms2:.4f} ms over CUDA events: gmm_logsumexp "
          f"{gmm132['ms']:.4f} + scores' transpose {tr_ms2:.4f} + frame_step {fs_ms2:.4f} = "
          f"{gmm132['ms'] + tr_ms2 + fs_ms2:.4f} ms | {card}", flush=True)
    del x2, carry, fs2
    phase_done("6b B=132")

    # ---- 7. card vs CPU parity on one short utterance -----------------------
    # a whole sentence (sampled above): a cut one reaches no final state and
    # has no words
    cpu_scorer = make_gmm_scorer(params, device="cpu")
    r_card, ys_card, r_cpu, ys_cpu = card_cpu_parity(art, cfg, dec, sc_card)
    r_plain, ys_plain = decode_records(TorchDecoder(art, cfg, device="cpu"), cpu_scorer(xs))
    rec_names = ("rec_prev", "rec_seq", "rec_src", "rec_arc")
    plain_rec = all((ys_card[k] == ys_plain[k]).all() for k in rec_names)
    transcript = [labels[w] for w in words_s]
    ok_words = [w for w in r_card.words if w not in markers] == transcript
    print(f"[parity] {xs.shape[0]} frames, {len(r_card.words)} words (transcript "
          f"{ok_words}): card vs cpu (same scores) words, frames and records equal; card "
          f"vs cpu plain scorer words {r_card.words == r_plain.words}, frames "
          f"{frames_of(r_card) == frames_of(r_plain)}, records {plain_rec}, "
          f"score diff {abs(r_card.score - r_plain.score):.2e}", flush=True)
    if not (ok_words and r_card.words == r_plain.words
            and frames_of(r_card) == frames_of(r_plain)):
        raise RuntimeError("card and CPU decodes disagree")
    del r_cpu, ys_cpu
    phase_done("7 parity")

    variants_phase(art, cfg, scorer, xs, words_s, labels, markers, card)
    phase_done("variants")
    lattice_phase("2k", art, cfg, scorer, xs, card, against_cpu=True)
    phase_done("2k lattice")

    loop_lib = stream_audio_library(art, task, scorer, dev)
    phase_done("2k stream audio")
    gloo = phase_mesh_gloo_2k(card, results, len(utts), phase_done)

    at_2k = dict(fs_ms=fs_ms, fs_ms2=fs_ms2, fps=fps, fps2=fps2, fps_device=fps_device,
                 fps_device2=fps_device2, gmm16=gmm16, gmm132=gmm132)
    # release the 2k task's tables and waves before the CLI's and the 20k
    # task's; keep the results the CLI is held to
    cli_lib = dict(utts=utts[:4], results=results[:4], sent=(words_s, xs.numpy()),
                   sent_result=r_card, transcript=transcript, markers=markers, loop=loop_lib)
    del task, art, dec, bd, fs, scores, scores_tbg, x, feats, sc_card, plain_results
    gc.collect()
    torch.cuda.empty_cache()
    cli_lib["clg"] = phase_toolchain_2k(card, host_builds, phase_done)
    cli_lib["host_builds"] = host_builds
    cli2k = phase_cli_2k(card, dev, cli_lib, phase_done)
    k20 = phase_20k(card, dev, at_2k, phase_done)
    # release the static 20k task (its host artifact and 5.73 GB of tables)
    # before the CLI builds its own from the text files
    cli_lib = k20.pop("cli")
    gc.collect()
    torch.cuda.empty_cache()
    cli20 = phase_cli_20k(card, dev, cli_lib, phase_done)
    # release the CLI's decoder before the on-the-fly pair's
    del cli_lib
    gc.collect()
    torch.cuda.empty_cache()
    cl20 = phase_toolchain_20k(card, phase_done)
    otf = phase_otf(card, dev, k20.pop("static"), phase_done)
    cli_lib = otf.pop("cli")
    otf_pair = otf.pop("pair")
    cli_lib["cl"] = cl20
    del cl20
    gc.collect()
    cliotf, G = phase_cli_otf(card, dev, cli_lib, phase_done)
    phase_gramgen_20k(card, G, phase_done)
    botf = phase_bench_otf(card, phase_done)
    scale = phase_scale_1m(card, dev, gmm16, phase_done)
    phase_pipeline_scale(card, phase_done)
    pstep = phase_profile_step(card, phase_done)
    potf = phase_profile_otf_step(card, dev, otf_pair, phase_done)
    del otf_pair
    probe = phase_pallas_probe(card, dev, phase_done)
    graft = phase_graft_entry(card, dev, phase_done)
    cli = {k: {**cli2k[k], **cli20[k], **cliotf[k], **botf[k], **scale[k], **pstep[k],
               **potf[k], **graft[k]}
           for k in ("gmm_logsumexp", "frame_step")}

    # ---- 8. result ------------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "gmm_logsumexp", "route": "cuda",
        "source": "juicer_tpu_torch/csrc/gmm_logsumexp.cu",
        "replaces": "juicer_tpu/ops/gmm_pallas.py:29",
        "launches": launches, "max_abs_err": gmm16["err"], "ms": gmm16["ms"],
        "plain_ms": gmm16["plain_ms"], "bound_ms": gmm16["bound_ms"],
        "bound_by": gmm16["bound_by"], "library_ms": gmm16["library_ms"],
        "max_abs_err_b132": gmm132["err"], "ms_b132": gmm132["ms"],
        "plain_ms_b132": gmm132["plain_ms"], "bound_ms_b132": gmm132["bound_ms"],
        "library_ms_b132": gmm132["library_ms"], "launches_b132": launches2[0],
        **k20["gmm_logsumexp"], **otf["gmm_logsumexp"], **cli["gmm_logsumexp"],
        "launches_gloo": gloo["gmm_logsumexp"],
    }, {
        "name": "frame_step", "route": "cuda",
        "source": "juicer_tpu_torch/csrc/frame_step.cu",
        "replaces": "juicer_tpu/decoder/pallas_scan.py:285",
        "launches": fs_launches, "max_abs_err": float_err, "equal_to_plain": True,
        "ms": fs_ms, "plain_ms": t_plain_diag * 1e3, "bound_ms": fs_bound,
        "bound_by": fs_bound_by, "library_ms": None,
        "bound_ms_dense": dense_bound, "ms_b132": fs_ms2,
        "launches_b132": launches2[1],
        **k20["frame_step"], **otf["frame_step"], **cli["frame_step"],
        "launches_gloo": gloo["frame_step"],
    }, {
        "name": "path_walk", "route": "cuda",
        "source": "juicer_tpu_torch/csrc/frame_step.cu",
        "replaces": "juicer_tpu/decoder/tpu_core.py:1446",
        "launches": walk_launches, "equal_to_plain": True, "ms": walk16["ms"],
        "plain_ms": walk16["plain_ms"], "bound_ms": walk16["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "path_rows": walk16["rows"], "dtoh_bytes": walk16["bytes"],
        "ms_b132": walk132["ms"], "launches_b132": launches2[2],
        **k20["path_walk"],
    }, probe]}))
    print("[time] phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items())
          + f"; total {sum(phase_s.values()):.1f}", flush=True)
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


# [variants]: each configuration outside the frame-step kernel, through the
# plain frame loop on the card (`use_fused=False`), held to the CPU
VARIANTS = (("float64", dict(dtype="float64")),
            ("exact", dict(histogram_mode="exact")),
            ("sort", dict(merge_strategy="sort")),
            ("sort+lattice", dict(merge_strategy="sort", gen_lattice=True)))


def phase_mesh_gloo_2k(card, results, n_utts, phase_done):
    """[mesh gloo 2k]: the multi-process demo, two `gloo` ranks on the card,
    each decoding its round-robin share of the 2k utterances; every
    utterance must equal this process's result (`results[u]`, the main
    path's wave) and the summed totals this process's sums. Returns each
    kernel's launches summed over the ranks."""
    n = 2
    cmd = [sys.executable, "-m", "juicer_tpu_torch.parallel.multihost_demo", str(n),
           "--task", "2k", "--device", "cuda", "--timeout", "240"]
    t0 = time.perf_counter()
    # the demo kills its workers at its own time limit, before this one
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=ROOT)
    seconds = time.perf_counter() - t0
    if out.returncode != 0:
        raise RuntimeError(f"mesh gloo 2k: the demo exited {out.returncode}: "
                           f"{out.stderr[-3000:]}")
    got, aggs = {}, []
    for line in out.stdout.splitlines():
        if line.startswith("WORKER_RESULT "):
            r = json.loads(line[len("WORKER_RESULT "):])
            got[r["utt"]] = r
        elif line.startswith("WORKER_AGG "):
            aggs.append(json.loads(line[len("WORKER_AGG "):]))
    if sorted(got) != list(range(n_utts)) or len(aggs) != n:
        raise RuntimeError(f"mesh gloo 2k: results of utterances {sorted(got)} and {len(aggs)} "
                           f"totals, expected {n_utts} and {n}: {out.stdout[-2000:]}")
    for u in range(n_utts):
        r, want = got[u], results[u]
        if (r["words"] != list(want.words) or r["end_frames"] != frames_of(want)
                or r["score"] != want.score or r["n_frames"] != want.n_frames or r["overflow"]):
            raise RuntimeError(f"mesh gloo 2k: utterance {u} differs from the in-process "
                               f"result: {r} against {want.words}, {frames_of(want)}, "
                               f"{want.score}")
    sums = (sum(len(r.words) for r in results[:n_utts]),
            sum(r.n_frames for r in results[:n_utts]), n_utts)
    launches = {"gmm_logsumexp": 0, "frame_step": 0}
    for a in aggs:
        if (a["words"], a["frames"], a["utts"]) != sums:
            raise RuntimeError(f"mesh gloo 2k: rank {a['rank']} summed {a}, expected {sums}")
        if a["launches"] != {"gmm_logsumexp": 1, "frame_step": 1}:
            raise RuntimeError(f"mesh gloo 2k: rank {a['rank']} launched {a['launches']}, "
                               f"expected one of each kernel for its share")
        for k in launches:
            launches[k] += a["launches"][k]
    ok = [line for line in out.stdout.splitlines() if line.startswith("MULTIHOST OK")]
    decode_s = ", ".join(f"{a['decode_s']:.3f}" for a in sorted(aggs, key=lambda a: a["rank"]))
    print(f"[mesh gloo 2k] {ok[0] if ok else 'no MULTIHOST OK line'}; {n} gloo ranks on "
          f"{sorted({a['device'] for a in aggs})}, each one launch of each kernel for its "
          f"share; every utterance's words, word-end frames and score equal this "
          f"process's, totals {list(sums)} equal its sums; decode {decode_s}s a rank; "
          f"the demo's wall {seconds:.1f}s (processes' start, CUDA, task load "
          f"included) | {card}", flush=True)
    if not ok:
        raise RuntimeError("mesh gloo 2k: rank 0 printed no MULTIHOST OK line")
    phase_done("mesh gloo 2k")
    return launches


def variants_phase(art, cfg, scorer, xs, words, labels, markers, card):
    """[variants]: one short sentence scored by the GMM kernel, decoded on
    the card with each configuration of `VARIANTS` through the plain frame
    loop and equal to the same decoder on the CPU; "auto" refuses each on
    the card with `why_not_fused`'s reason. Launch counts are zeroed just
    before and read just after. Returns {name: ms a frame}."""
    import torch

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch, host_planes_diff
    from juicer_tpu_torch.ops import gmm_cuda

    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    sc = scorer(xs.to("cuda"))
    T = int(sc.shape[0])
    transcript = [labels[w] for w in words]
    out = {}
    for name, kw in VARIANTS:
        vcfg = dataclasses.replace(cfg, **kw)
        extra = ""
        if name == "exact":
            # WSJ_POINT's maxHyps of 500 does not bind on this sentence: the
            # first of the peak of active slots in the decode without a
            # histogram (each slot holds up to three emitting hypotheses),
            # its half and its quarter whose records differ from that decode
            free = TorchDecoder(art, dataclasses.replace(vcfg, max_emit_hyps=0), device="cuda")
            free_ys = free.run(sc[None])[1]
            free_prev, peak = free_ys["rec_prev"], int(free_ys["n_active"].max())
            for k in (peak, peak // 2, peak // 4):
                vcfg = dataclasses.replace(vcfg, max_emit_hyps=k)
                bound_prev = TorchDecoder(art, vcfg, device="cuda").run(sc[None])[1]["rec_prev"]
                if not torch.equal(free_prev, bound_prev):
                    break
            else:
                raise RuntimeError(f"[variants] exact: maxHyps {peak}, {peak // 2} and "
                                   f"{peak // 4} do not bind")
            extra = (f"; maxHyps {k} binds (peak of active slots without it {peak}): the "
                     f"records differ from the decode without it")
            del free, free_ys, free_prev, bound_prev
        dec = TorchDecoder(art, vcfg, device="cuda")
        why = fused_scan.why_not_fused(dec)
        try:
            dec.decode_scores(sc)
        except ValueError as e:
            if why is None or why not in str(e):
                raise RuntimeError(f"[variants] {name}: 'auto' raised without the reason") from e
        else:
            raise RuntimeError(f"[variants] {name}: use_fused='auto' decoded on the card")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = dec.run(sc[None])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / T
        got = host_batch(*state)
        cpu = TorchDecoder(art, vcfg, device="cpu")
        want = host_batch(*cpu.run(sc.cpu()[None]))
        tol = 1e-9 if vcfg.dtype == "float64" else 1e-4
        try:
            worst = host_planes_diff(got, want, tol)
        except ValueError as e:
            raise RuntimeError(f"[variants] {name}: the card differs from the CPU: {e}") from e
        r_card = dec.traceback(got, 0, T)
        r_cpu = cpu.traceback(want, 0, T)
        r_entry = dec.decode_scores(sc, use_fused=False)
        if r_cpu.empty:
            raise RuntimeError(f"[variants] {name}: the sentence decodes to no final state")
        for r, other in ((r_card, "the CPU"), (r_entry, "decode_scores(use_fused=False)")):
            if r.words != r_cpu.words or frames_of(r) != frames_of(r_cpu):
                raise RuntimeError(f"[variants] {name}: the card's words differ from {other}")
        print(f"[variants] {name}: not in the kernel ({why}); 'auto' raises on the card; "
              f"plain loop on the card {T} frames at {ms:.3f} ms a frame; records and every "
              f"plane equal to the CPU (max |float diff| {worst}), words and word-end frames "
              f"equal; transcript {[w for w in r_card.words if w not in markers] == transcript}"
              f"{extra} | {card}", flush=True)
        out[name] = ms
        del dec, cpu, state, got, want
    launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if launches[0] == 0 or launches[1] != 0:
        raise RuntimeError(f"[variants] launched gmm_logsumexp, frame_step {launches} times; "
                           f"expected > 0 and 0")
    print(f"[variants] launches: gmm_logsumexp {launches[0]}, frame_step {launches[1]} (the "
          f"plain loop decodes these configurations, as the JAX engine's lax.scan does)",
          flush=True)
    return out


def lattice_phase(what, art, cfg, scorer, xs, card, against_cpu, g=None):
    """[lattice]: one utterance through `decode_scores_lattice` on the card
    (the plain loop: "auto" raises); its best path is the 1-best words at
    cost -(ac+lm) within 1e-3, and with `against_cpu` the lattice equals
    the CPU's (states, arcs, labels; weights within 1e-4). Prints the
    decode's ms a frame, `build_lattice`'s and `connect`'s seconds, the
    lattice before and after `connect` and the bytes of the lattice
    records copied to the host. Launch counts are zeroed just before and
    read just after. With `g` the decoder composes with that G on the fly
    (the `[otf] lattice` line)."""
    import torch

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.decoder.core import FLAT_FIELDS, TorchDecoder, host_batch
    from juicer_tpu_torch.decoder.lattice import build_lattice, shortest_path
    from juicer_tpu_torch.fst import algos
    from juicer_tpu_torch.ops import gmm_cuda

    tag = "[otf] lattice" if g is not None else f"[lattice] {what}"
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    sc = scorer(xs.to("cuda"))
    T = int(sc.shape[0])
    lcfg = dataclasses.replace(cfg, gen_lattice=True)
    dec = TorchDecoder(art, lcfg, device="cuda", g_network=g)
    try:
        dec.decode_scores_lattice(sc)
    except ValueError as e:
        if fused_scan.why_not_fused(dec) not in str(e):
            raise RuntimeError(f"{tag}: 'auto' raised without the reason") from e
    else:
        raise RuntimeError(f"{tag}: use_fused='auto' decoded on the card")
    res, lat = dec.decode_scores_lattice(sc, use_fused=False)
    launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    cost, words = shortest_path(lat)
    err = abs(cost + res.acoustic_score + res.lm_score)
    if words != res.words or not res.words or not err <= 1e-3:
        raise RuntimeError(f"{tag}: best path {words} at {cost} vs 1-best "
                           f"{res.words} at {-(res.acoustic_score + res.lm_score)}")
    # the entry point's parts, timed apart
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = dec.run(sc[None])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / T
    host = host_batch(*state)
    ys = {k: host[1][k][:, 0] for k in dec.lat_fields + FLAT_FIELDS + dec.ev_fields}
    rec0 = {k: host[2][k][0] for k in dec.lat_fields + dec.ev_fields}
    ef_bytes = sum(ys[k].nbytes for k in dec.lat_fields + FLAT_FIELDS)
    k_bytes = sum(ys[k].nbytes for k in dec.ev_fields)
    t0 = time.perf_counter()
    raw = build_lattice(art, ys, rec0, T)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    built = algos.connect(raw)
    t_connect = time.perf_counter() - t0
    if (built.num_states, built.arc_src, built.arc_dst, built.arc_weight) != (
            lat.num_states, lat.arc_src, lat.arc_dst, lat.arc_weight):
        raise RuntimeError(f"{tag}: a second build differs from the entry point's")
    edges = int(ys["lat_valid"].sum())
    cpu_note = ""
    if against_cpu:
        _, lat_cpu = TorchDecoder(art, lcfg, device="cpu",
                                  g_network=g).decode_scores_lattice(sc.cpu())
        same = (lat.num_states, lat.start, lat.arc_src, lat.arc_dst, lat.arc_ilabel,
                lat.arc_olabel, sorted(lat.finals)) == (
            lat_cpu.num_states, lat_cpu.start, lat_cpu.arc_src, lat_cpu.arc_dst,
            lat_cpu.arc_ilabel, lat_cpu.arc_olabel, sorted(lat_cpu.finals))
        w_err = max([abs(a - b) for a, b in zip(lat.arc_weight, lat_cpu.arc_weight)]
                    + [abs(lat.finals[s] - lat_cpu.finals[s]) for s in lat_cpu.finals
                       if s in lat.finals] + [0.0])
        if not same or not w_err <= 1e-4:
            raise RuntimeError(f"{tag}: the card's lattice differs from the CPU's "
                               f"(structure equal {same}, max |weight diff| {w_err})")
        cpu_note = (f"; equal to the CPU's lattice (states, arcs, labels; max |weight diff| "
                    f"{w_err})")
    if launches[0] == 0 or launches[1] != 0:
        raise RuntimeError(f"{tag}: launched gmm_logsumexp, frame_step {launches} "
                           f"times; expected > 0 and 0")
    print(f"{tag}: {T} frames, decode (plain loop on the card) {ms:.3f} ms a "
          f"frame, build_lattice {t_build:.3f} s for {edges} edges ({edges / T:.1f} a frame), "
          f"connect {t_connect:.3f} s; "
          f"lattice {raw.num_states} states / {raw.num_arcs} arcs before connect, "
          f"{lat.num_states} / {lat.num_arcs} after; best path = the 1-best's "
          f"{len(words)} words, cost error {err:.2e}{cpu_note}; lattice records to the host "
          f"{ef_bytes} bytes of E- and F-wide fields ({ef_bytes / T:.0f} a frame) and "
          f"{k_bytes} of K-wide events; launches gmm_logsumexp {launches[0]}, frame_step "
          f"{launches[1]} | {card}", flush=True)
    return dict(ms=ms, build_s=t_build, ef_bytes=ef_bytes, states=lat.num_states,
                arcs=lat.num_arcs)


def decode_records(decoder, scores):
    """One utterance through the plain frame loop: (result, host records)."""
    from juicer_tpu_torch.decoder.core import host_batch

    host = host_batch(*decoder.run(scores[None]))
    return decoder.traceback(host, 0, scores.shape[0]), host[1]


def card_cpu_parity(art, cfg, dec, sc_card):
    """The same scores through the plain loop on the card and on the CPU
    (words, word-end frames and traceback records equal), and through
    `decode_scores` on the card (one launch of the kernel and of the walk,
    the same result). Returns the card's and the CPU's (result, records)."""
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.decoder.core import TorchDecoder

    r_card, ys_card = decode_records(dec, sc_card)
    n0, w0 = fused_scan.counter.launches, fused_scan.walk_counter.launches
    r_entry = dec.decode_scores(sc_card)  # the card's route: the kernel at B=1
    n = (fused_scan.counter.launches - n0, fused_scan.walk_counter.launches - w0)
    if n != (1, 1):
        raise RuntimeError(f"decode_scores on the card launched frame_step, path_walk {n} "
                           f"times; expected once each")
    if not same_result(r_entry, r_card):
        raise RuntimeError("decode_scores through the kernel differs from the plain loop")
    r_cpu, ys_cpu = decode_records(TorchDecoder(art, cfg, device="cpu"), sc_card.cpu())
    same_rec = all((ys_card[k] == ys_cpu[k]).all()
                   for k in ("rec_prev", "rec_seq", "rec_src", "rec_arc"))
    if not (same_rec and r_card.words == r_cpu.words and frames_of(r_card) == frames_of(r_cpu)):
        raise RuntimeError(f"card and CPU decodes of the same scores disagree (records "
                           f"{same_rec}, words {r_card.words == r_cpu.words})")
    return r_card, ys_card, r_cpu, ys_cpu


def mesh_20k(card, dec, scorer, waves, plain_results, entry, utts, labels, markers,
             table_bytes):
    """[mesh 20k]: `BatchDecoder` over meshes of replicas on the one card
    (see the module docstring). `waves` maps each batch size to its
    features, true lengths and Tmax. Returns the kernels line's mesh
    fields."""
    import torch

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.parallel.mesh import BatchDecoder, shares

    dev = dec.device
    B = len(plain_results)
    G = scorer.n_gmms
    launches = [0, 0]
    growth = {}
    for mesh, b in (((dev, dev), B), ((dev, dev), B2), ((dev, dev, dev), B)):
        xx, lens, Tmax = waves[b]
        D = xx.shape[-1]
        # the cycle collector would otherwise free earlier tensors in between
        gc.collect()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        bd = BatchDecoder(dec, mesh=mesh)
        m1 = torch.cuda.memory_allocated(dev)
        if m1 > m0 or list(bd.replicas.values()) != [dec]:
            raise RuntimeError(f"mesh 20k: replicas on one card allocated {m1 - m0} bytes")
        # each share's features scored on the share's device
        scorers = {dev: scorer}
        parts = [(d, lo, hi) for d, (lo, hi) in zip(mesh, shares(b, len(mesh))) if hi > lo]

        def call():
            sc = [scorers[d](xx.view(b, Tmax, D)[lo:hi].reshape(-1, D)).view(hi - lo, Tmax, G)
                  for d, lo, hi in parts]
            return bd.decode_scores_batch(torch.cat([s.to(mesh[0]) for s in sc]), lens)

        gmm_cuda.counter.launches = 0
        fused_scan.counter.launches = 0
        fused_scan.walk_counter.launches = 0
        got = call()
        n = (gmm_cuda.counter.launches, fused_scan.counter.launches,
             fused_scan.walk_counter.launches)
        if n != (len(parts),) * 3:
            raise RuntimeError(f"mesh 20k: {len(parts)} shares launched gmm_logsumexp, "
                               f"frame_step, path_walk {n} times; expected one each a share")
        launches[0] += n[0]
        launches[1] += n[1]
        torch.cuda.synchronize()
        m2 = torch.cuda.memory_allocated(dev)
        if m2 - m0 >= table_bytes // 2:
            raise RuntimeError(f"mesh 20k: the mesh holds {m2 - m0} more bytes, as much as "
                               f"a second copy of the {table_bytes} bytes of tables")
        certify(got, f"mesh 20k {len(mesh)}x B={b}", utts, labels, markers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = call()
        t_mesh = time.perf_counter() - t0
        for i, (r, a) in enumerate(zip(got, again)):
            if not same_result(r, plain_results[i % B]) or not same_result(a, r):
                raise RuntimeError(f"mesh 20k {len(mesh)}x B={b}: utterance {i} differs from "
                                   f"the single-device results")
        growth[f"{len(mesh)}x{b}"] = m2 - m0
        print(f"[mesh 20k] {len(mesh)} replicas on {dev}, B={b} in shares of "
              f"{[hi - lo for _, lo, hi in parts]}: launches gmm_logsumexp {n[0]}, frame_step "
              f"{n[1]}, path_walk {n[2]} (one each a share); every utterance's words, word-end frames and "
              f"score equal the single-device results, certified; memory_allocated {m0} "
              f"before the replicas, {m1} after them ({len(bd.replicas)} decoder, tables "
              f"shared), {m2} after the decode (+{m2 - m0} bytes: the shares' scans' "
              f"carries; the tables are {table_bytes}); wall {t_mesh:.4f}s a call "
              f"(GMM + decode + copy + traceback) beside {entry[b][2]:.4f}s on one device, "
              f"replicas on one card, not a scaling number | {card}", flush=True)
        del bd, got, again
    return {"launches_mesh": launches[1], "gmm_launches_mesh": launches[0],
            "mesh_bytes_growth": growth}


def mesh_plain(card, dec, sc):
    """[mesh 20k], the plain route over a mesh of two replicas on the card:
    one sentence's (T, G) scores twice, shares of 1 + 1, each equal to
    `decode_scores(use_fused=False)`."""
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.parallel.mesh import BatchDecoder

    want = dec.decode_scores(sc, use_fused=False)
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    got = BatchDecoder(dec, mesh=(dec.device, dec.device), use_fused=False).decode_scores_batch(
        sc[None].expand(2, -1, -1))
    t_mesh = time.perf_counter() - t0
    if fused_scan.counter.launches or not all(
            same_result(r, want) and r.n_frames == want.n_frames for r in got):
        raise RuntimeError("mesh 20k plain: the mesh's plain route differs from "
                           "decode_scores(use_fused=False)")
    print(f"[mesh 20k] plain route (use_fused=False), 2 replicas on {dec.device}, the parity "
          f"sentence twice ({sc.shape[0]} frames, shares 1 + 1): equal to "
          f"decode_scores(use_fused=False), frame_step launches 0; {t_mesh:.3f}s | {card}",
          flush=True)


def phase_20k(card, dev, at_2k, phase_done):
    """[20k]: the reference bench's own task on the card (see the module
    docstring). Returns the kernels line's 20k fields."""
    import torch

    from juicer_tpu_torch.decoder import autotune_budgets, fused_scan
    from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch
    from juicer_tpu_torch.decoder.fused_scan import FusedDecodeScan
    from juicer_tpu_torch.decoder.stream import StreamingDecoder
    from juicer_tpu_torch.harness import wsj_task
    from juicer_tpu_torch.harness.profile_decode import plain_loop_profile
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.ops.gmm import make_gmm_scorer
    from juicer_tpu_torch.parallel.mesh import BatchDecoder

    p = wsj_task.WSJ_POINT
    B = p["batch"]
    # the smoke reads the artifact once: built in memory, no cache written
    task = wsj_task.load_task("20k", cache=False)
    art = task.artifact
    n_ent = len(art.expansion.arc)
    c = task.costs
    print(f"[20k] {task.net.n_arcs} arcs, {art.n_hmm_arcs} HMM arcs, {n_ent} closure "
          f"entries, {len(art.seqs)} label sequences: network read in {c['network_s']:.1f}s, "
          f"artifact built in memory in {c['build_s']:.1f}s (no cache written); peak host "
          f"RSS {c['peak_rss_bytes']} bytes ({c['peak_rss_bytes'] / 2**30:.2f} GiB)",
          flush=True)
    cfg = wsj_task.decoder_config(p, emit_diagnostics=True)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    dec = TorchDecoder(art, cfg, device="cuda")
    fused_scan._meta32(dec)
    torch.cuda.synchronize()
    t_upload = time.perf_counter() - t0
    table_bytes = torch.cuda.memory_allocated() - m0
    why = fused_scan.why_not_fused(dec)
    print(f"[20k] tables on the card: {table_bytes} bytes ({table_bytes / 1e9:.3f} GB; the "
          f"entry tables {24 * n_ent} of them), copied and converted in {t_upload:.2f}s; "
          f"K x largest fan-out {dec.K * fused_scan._max_fan(dec)}; fused scope: "
          f"{why or 'covered'}", flush=True)
    if why is not None:
        raise RuntimeError(f"20k: the fused scan does not cover the operating point: {why}")
    phase_done("20k task")

    models = task.models
    params = models.flat_params()
    G, D = params.n_gmms, params.vec_size
    utts = wsj_task.sample_utterances(task.cache, models, n_utts=p["n_utts"],
                                      target_frames=p["frames"], seed=11)
    feats, lengths, Tmax = tile_features(utts, B, dev)
    labels, markers = wsj_task.word_labels(task.cache)
    print(f"[20k] {len(utts)} utterances T={[f.shape[0] for _, f in utts]}, batch {B} x "
          f"{Tmax} and {B2} x {Tmax}; {len(labels)} words", flush=True)
    scorer = make_gmm_scorer(params, device="cuda")
    x = feats.reshape(B * Tmax, D).contiguous()
    x2 = x.view(B, Tmax, D)[torch.arange(B2, device=dev) % B].reshape(B2 * Tmax, D)
    gmm16 = gmm_phase(scorer, x, f"20k B={B}", card)
    gmm132 = gmm_phase(scorer, x2, f"20k B={B2}", card)
    # repeated readings at the B=16 shape: one earlier call read 0.1646 ms
    # where the call before it read 0.1021
    repeats = [cuda_ms(lambda: gmm_cuda.gmm_logsumexp(x, scorer.W, scorer.b_packed, G), 20)
               for _ in range(5)]
    print(f"[20k] gmm_logsumexp at B={B} (T={x.shape[0]}) read five more times, 20 calls "
          f"each over CUDA events: {', '.join(f'{m:.4f}' for m in repeats)} ms | {card}",
          flush=True)
    print(f"[20k] gmm_logsumexp {gmm16['ms']:.4f} ms at B={B} and {gmm132['ms']:.4f} ms at "
          f"B={B2} beside {at_2k['gmm16']['ms']:.4f} and {at_2k['gmm132']['ms']:.4f} ms at 2k "
          f"(the same models, longer waves) | {card}", flush=True)
    phase_done("20k gmm")

    # ---- autotune: the operating point's budgets, through the kernel -------
    samples = [scorer(torch.as_tensor(f, device=dev)) for _, f in utts]
    t0 = time.perf_counter()
    tuned = autotune_budgets(art, samples, cfg=cfg, margin=1.4, device="cuda", verbose=True)
    t_tune = time.perf_counter() - t0
    tdec = TorchDecoder(art, dataclasses.replace(tuned, emit_diagnostics=True), device="cuda")
    n0 = fused_scan.counter.launches
    checked = [tdec.decode_scores(s) for s in samples]
    if fused_scan.counter.launches - n0 != len(samples):
        raise RuntimeError("20k: the tuned budgets' check did not run through the kernel")
    certify(checked, "20k tuned", utts, labels, markers)
    print(f"[20k] autotune_budgets (margin 1.4, start K={p['K']} E={p['E']}, through the "
          f"frame-step kernel, {t_tune:.1f}s): tuned K={tuned.max_insts} "
          f"E={tuned.expand_budget} F={tuned.final_budget}; with them peak active "
          f"{max(r.max_active for r in checked)}, peak candidates "
          f"{max(r.max_cand for r in checked)}; verified: {len(samples)} utterances, "
          f"overflow 0, transcripts exact", flush=True)
    del tdec, checked
    phase_done("20k autotune")

    # ---- the plain reference wave and the kernel held to it ---------------
    scores = scorer(x).view(B, Tmax, G)
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_state = dec.run(scores)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    if fused_scan.counter.launches:
        raise RuntimeError("20k: the plain wave launched frame_step")
    host = host_batch(*plain_state)
    plain_results = [dec.traceback(host, b, Tmax, true_T=lengths[b]) for b in range(B)]
    del host
    certify(plain_results, "20k plain", utts, labels, markers)
    static = dict(plain_ms_frame=t_plain * 1e3 / Tmax, B=B,
                  **plain_loop_profile(dec, scores))
    print(f"[20k] plain frame loop at B={B}: {static['plain_ms_frame']:.3f} ms a frame step "
          f"over the wave; over 20 frames {static['wall_ms']:.3f} ms a frame step, "
          f"{static['launches_per_frame']:.2f} kernel launches and {static['kernel_ms']:.4f} "
          f"ms of kernels a frame step (torch.profiler), device idle share "
          f"{static['idle']:.3f} | {card}", flush=True)
    fs = FusedDecodeScan(dec, B)
    scores_tbg = scores.transpose(0, 1).contiguous()
    fused_state, _, walk16 = hold_to_plain("20k fused", dec, fs, scores_tbg, plain_state,
                                           plain_results, lengths)
    n_cand, n_active, n_rec = wave_counts(fused_state[1])
    print(f"[20k] plain frame loop {B} x {Tmax} in {t_plain:.3f}s; the frame-step kernel "
          f"equal to it bit for bit (compact records, their expansion, 8 snapshots, carry, "
          f"words and word-end frames); {n_cand} candidates, {n_active} active slot-frames, "
          f"{n_rec} records", flush=True)
    del plain_state, fused_state
    phase_done("20k fused vs plain")

    # ---- certification through BatchDecoder at B=16 and B=132 -------------
    bd = BatchDecoder(dec)
    lengths2 = [lengths[i % B] for i in range(B2)]
    entry = {}
    for b, xx, lens in ((B, x, lengths), (B2, x2, lengths2)):
        gmm_cuda.counter.launches = 0
        fused_scan.counter.launches = 0
        fused_scan.walk_counter.launches = 0
        got = bd.decode_scores_batch(scorer(xx).view(b, Tmax, G), lens)
        t0 = time.perf_counter()
        again = bd.decode_scores_batch(scorer(xx).view(b, Tmax, G), lens)
        t_entry = time.perf_counter() - t0
        launches = (gmm_cuda.counter.launches, fused_scan.counter.launches,
                    fused_scan.walk_counter.launches)
        if launches != (2, 2, 2):
            raise RuntimeError(f"20k B={b}: two waves launched gmm_logsumexp, frame_step, "
                               f"path_walk {launches} times; expected one each a wave")
        certify(got, f"20k B={b}", utts, labels, markers)
        for i, (a, r) in enumerate(zip(got, again)):
            if not same_result(a, r) or not same_result(a, plain_results[i % B]):
                raise RuntimeError(f"20k B={b}: utterance {i} differs from the B={B} wave")
        entry[b] = (launches, b * Tmax / t_entry, t_entry)
        del got, again
    phase_done("20k BatchDecoder")
    mesh = mesh_20k(card, dec, scorer, {B: (x, lengths, Tmax), B2: (x2, lengths2, Tmax)},
                    plain_results, entry, utts, labels, markers, table_bytes)
    phase_done("mesh 20k")

    # ---- times: the kernel a wave, device-only and entry-point rates -------
    fs_ms = cuda_ms(lambda: fs(scores_tbg), 3)
    fs2 = bd._fs[dec.device, B2]
    scores2_tbg = scorer(x2).view(B2, Tmax, G).transpose(0, 1).contiguous()
    fs_ms2 = cuda_ms(lambda: fs2(scores2_tbg), 3)
    walk132 = hold_walk(f"20k B={B2}", fs2, fs2(scores2_tbg), lengths2)
    del scores2_tbg
    bound, bound_by, nbytes, ops, _ = frame_step_bound(dec, B, Tmax, scores_tbg.numel(),
                                                       n_cand, n_active, n_rec)
    device = {}
    for b, xx, f in ((B, x, fs), (B2, x2, fs2)):
        def wave():
            return f(scorer(xx).view(b, Tmax, G).transpose(0, 1).contiguous())

        wave()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, _ = wave()
        torch.cuda.synchronize()
        t_wave = time.perf_counter() - t0
        if int(carry["overflow"].sum()) or int((carry["best_final"]["score"] <= -0.5e30).sum()):
            raise RuntimeError(f"20k B={b}: fused device wave overflowed or died")
        device[b] = b * Tmax / t_wave
    print(f"[20k] frame_step {fs_ms:.3f} ms a wave of {B} x {Tmax} ({fs_ms * 1e3 / Tmax:.2f} "
          f"us a frame; 2k: {at_2k['fs_ms']:.3f} ms) and {fs_ms2:.3f} ms at B={B2} "
          f"({fs_ms2 * 1e3 / Tmax:.2f} us a frame; 2k: {at_2k['fs_ms2']:.3f} ms); bound at "
          f"B={B} {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G "
          f"operations) | {card}", flush=True)
    print(f"[20k] entry point {entry[B][1]:.1f} frames/s at B={B} (wave {entry[B][2]:.4f}s), "
          f"{entry[B2][1]:.1f} at B={B2} (wave {entry[B2][2]:.4f}s); device only "
          f"{device[B]:.1f} and {device[B2]:.1f} frames/s; 2k: entry point {at_2k['fps']:.1f} "
          f"and {at_2k['fps2']:.1f}, device only {at_2k['fps_device']:.1f} and "
          f"{at_2k['fps_device2']:.1f} | {card}", flush=True)
    del fs2, bd, scores_tbg, scores
    phase_done("20k times")

    # ---- the streaming decoder through the kernel --------------------------
    sc0 = samples[0]
    T0 = int(sc0.shape[0])
    ref = dec.decode_scores(sc0)
    stream = StreamingDecoder(dec)
    n0 = fused_scan.counter.launches
    emitted, per_chunk = [], []
    for i in range(0, T0, STREAM_CHUNK):
        new = stream.feed(sc0[i:i + STREAM_CHUNK])
        emitted += new
        per_chunk.append(len(new))
    fin = stream.finish()
    n_chunks = len(per_chunk)
    if fused_scan.counter.launches - n0 != n_chunks:
        raise RuntimeError(f"20k stream: {fused_scan.counter.launches - n0} launches for "
                           f"{n_chunks} chunks")
    hyps = [(h.word, h.end_frame) for h in fin.word_hyps]
    if [(h.word, h.end_frame) for h in emitted] != hyps[:len(emitted)]:
        raise RuntimeError("20k stream: a partial emission is not a prefix of the final words")
    if not same_result(fin, ref) or fin.empty:
        raise RuntimeError("20k stream: finish() differs from decode_scores")
    print(f"[20k] StreamingDecoder, {T0} frames in {n_chunks} chunks of {STREAM_CHUNK}: "
          f"{n_chunks} frame_step launches; words emitted per chunk {per_chunk} "
          f"({len(emitted)} of {len(fin.words)} before finish), each a prefix of the final "
          f"words; finish() equal to decode_scores (words, word-end frames, score)",
          flush=True)
    phase_done("20k stream")

    # ---- card vs CPU parity on one short whole sentence -------------------
    words_s, xs = wsj_task.sample_utterances(
        task.cache, models, n_utts=2, target_frames=250, seed=12)[1]
    sc_card = scorer(torch.as_tensor(xs, device=dev))
    t0 = time.perf_counter()
    r_card, _, _, _ = card_cpu_parity(art, cfg, dec, sc_card)
    ok_words = [w for w in r_card.words if w not in markers] == [labels[w] for w in words_s]
    print(f"[20k parity] {sc_card.shape[0]} frames, {len(r_card.words)} words: card and cpu "
          f"(same scores) words, word-end frames and traceback records equal; decode_scores "
          f"through one launch equal; transcript {ok_words} ({time.perf_counter() - t0:.1f}s)",
          flush=True)
    if not ok_words:
        raise RuntimeError("20k parity: the sentence's words are not its transcript")
    phase_done("20k parity")
    mesh_plain(card, dec, sc_card)
    phase_done("mesh 20k plain")
    lattice_phase("20k", art, cfg, scorer, torch.as_tensor(xs), card, against_cpu=False)
    phase_done("20k lattice")
    audio = audio_library(task, dec, [f.shape[0] for _, f in utts] * 2, dev, card)
    phase_done("20k audio")
    del dec, fs
    gc.collect()
    torch.cuda.empty_cache()
    tools = [phase_wsj_bench_20k(card, task, tuned, plain_results, phase_done),
             phase_wsj_sweep_20k(card, task, phase_done)]

    static["entry_fps"] = entry[B][1]
    return {
        "static": static,
        "cli": dict(utts=utts, results=plain_results, markers=markers, entry_fps=entry[B][1],
                    audio=audio),
        "gmm_logsumexp": {
            "ms_20k": gmm16["ms"], "ms_20k_b132": gmm132["ms"], "ms_20k_repeats": repeats,
            "bound_ms_20k": gmm16["bound_ms"], "bound_ms_20k_b132": gmm132["bound_ms"],
            "max_abs_err_20k": max(gmm16["err"], gmm132["err"]),
            "launches_20k": entry[B][0][0], "launches_20k_b132": entry[B2][0][0],
            "launches_mesh": mesh["gmm_launches_mesh"],
            **tools[0]["gmm_logsumexp"], **tools[1]["gmm_logsumexp"]},
        "frame_step": {
            "ms_20k": fs_ms, "ms_20k_b132": fs_ms2, "bound_ms_20k": bound,
            "plain_ms_20k": t_plain * 1e3,
            "launches_20k": entry[B][0][1], "launches_20k_b132": entry[B2][0][1],
            "launches_mesh": mesh["launches_mesh"],
            "mesh_bytes_growth": mesh["mesh_bytes_growth"],
            **tools[0]["frame_step"], **tools[1]["frame_step"]},
        "path_walk": {
            "ms_20k": walk16["ms"], "ms_20k_b132": walk132["ms"],
            "plain_ms_20k": walk16["plain_ms"], "bound_ms_20k": walk16["bound_ms"],
            "path_rows_20k": walk16["rows"], "path_rows_20k_b132": walk132["rows"],
            "launches_20k": entry[B][0][2], "launches_20k_b132": entry[B2][0][2]},
    }


def phase_otf(card, dev, static, phase_done):
    """[otf]: on-the-fly composition at the 20k task on the card (see the
    module docstring). `static` holds the static 20k plain loop's numbers
    of this call. Returns the kernels line's OTF fields."""
    import numpy as np
    import torch

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch, host_planes_diff
    from juicer_tpu_torch.harness import wsj_bench, wsj_otf, wsj_task
    from juicer_tpu_torch.harness.profile_decode import plain_loop_profile
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.ops.gmm import make_gmm_scorer
    from juicer_tpu_torch.parallel.mesh import BatchDecoder

    p = wsj_task.OTF_POINT
    B = p["n_utts"]  # one wave of the distinct utterances
    t0 = time.perf_counter()
    task = wsj_task.load_otf_task("20k", verbose=False)
    t_load = time.perf_counter() - t0
    art, g, ex = task.artifact, task.g, task.artifact.expansion
    counts = (task.net.n_arcs, art.n_hmm_arcs, len(ex.arc), g.n_states, len(g.arc_il),
              g.max_backoff)
    if counts != (37443, 35098, 310115, 20004, 151567, 2):
        raise RuntimeError(f"[otf] task: CL arcs, HMM arcs, closure entries, G states, G word "
                           f"arcs, max_backoff are {counts}")
    t0 = time.perf_counter()
    art.anticipated_labels()
    t_ant = time.perf_counter() - t0
    cfg = wsj_task.decoder_config(p, emit_diagnostics=True)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    probe = TorchDecoder(art, dataclasses.replace(cfg, otf_pushing=True), device="cuda",
                         g_network=g)
    torch.cuda.synchronize()
    table_bytes = torch.cuda.memory_allocated() - m0
    g_bytes = sum(t.numel() * t.element_size() for t in probe.gtab.values())
    del probe
    c = task.costs
    print(f"[otf] task 20k: CL {counts[0]} arcs, {counts[1]} HMM arcs, {counts[2]} closure "
          f"entries, {len(ex.f_score)} final entries, largest fan-out "
          f"{int(np.diff(ex.row_ptr).max())}; G {counts[3]} states, {counts[4]} word arcs, "
          f"max_backoff {counts[5]}, vocabulary width {g.W}; loaded and built in {t_load:.2f}s "
          f"(network {c['network_s']:.2f}, CL artifact {c['artifact_s']:.2f}, ARPA grammar "
          f"{c['grammar_s']:.2f}, GNetwork {c['gnetwork_s']:.2f}); anticipated_labels "
          f"{t_ant:.3f}s; tables on the card {table_bytes} bytes (G and the label tables "
          f"{g_bytes} of them; the static 20k task's: 5.73 GB) | {card}", flush=True)
    phase_done("otf task")

    models = task.models
    params = models.flat_params()
    G, D = params.n_gmms, params.vec_size
    utts = wsj_task.sample_utterances(task.cache, models, n_utts=p["n_utts"],
                                      target_frames=p["frames"], seed=p["seed"])
    feats, lengths, Tmax = tile_features(utts, B, dev)
    labels, markers = wsj_task.word_labels(task.cache)
    scorer = make_gmm_scorer(params, device="cuda")
    x = feats.reshape(B * Tmax, D).contiguous()
    gmm8 = gmm_phase(scorer, x, f"otf B={B}", card)
    print(f"[otf] gmm: {len(utts)} utterances T={[f.shape[0] for _, f in utts]} (seed "
          f"{p['seed']}, the static 20k point's), batch {B} x {Tmax}; gmm_logsumexp within "
          f"{gmm8['err']:.3e} of the plain scorer (atol {GMM_ATOL}), {gmm8['ms']:.4f} ms | "
          f"{card}", flush=True)
    phase_done("otf gmm")

    samples = [scorer(torch.as_tensor(f, device=dev)) for _, f in utts]
    t0 = time.perf_counter()
    # [wsj otf 20k]: the tuner of `harness/wsj_otf` (margin 1.4, the route
    # named: the plain loop, since no kernel covers a G)
    tuned = wsj_otf.tune(art, samples, cfg, g, dev)
    t_tune = time.perf_counter() - t0
    print(f"[otf] autotune_budgets (g_network, margin {p['margin']}, start K={p['K']} "
          f"E={p['E']} F={cfg.final_budget}, plain loop on the card, {len(samples)} "
          f"utterances, {t_tune:.1f}s): tuned K={tuned.max_insts} E={tuned.expand_budget} "
          f"F={tuned.final_budget} (the JAX package's CPU run of scripts/wsj_otf.py tuned "
          f"K=2176 E=3840 over 4 utterances) | {card}", flush=True)
    phase_done("otf autotune")

    # ---- the main path: BatchDecoder over B=8, the plain loop ------------
    dec = TorchDecoder(art, dataclasses.replace(tuned, emit_diagnostics=True), device="cuda",
                       g_network=g)
    why = fused_scan.why_not_fused(dec)
    try:
        BatchDecoder(dec).decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    except ValueError as e:
        if why is None or why not in str(e):
            raise RuntimeError("[otf] 'auto' raised without why_not_fused's reason") from e
    else:
        raise RuntimeError("[otf] BatchDecoder(use_fused='auto') decoded on the card")
    bd = BatchDecoder(dec, use_fused=False)
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    results = bd.decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    t_cert = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = bd.decode_scores_batch(scorer(x).view(B, Tmax, G), lengths)
    t_entry = time.perf_counter() - t0
    launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if launches != (2, 0):
        raise RuntimeError(f"[otf] two waves launched gmm_logsumexp, frame_step {launches} "
                           f"times; expected 2 and 0")
    certify(results, "otf main path", utts, labels, markers)
    for i, (a, r) in enumerate(zip(again, results)):
        if not same_result(a, r):
            raise RuntimeError(f"[otf] the timed wave differs for utterance {i}")
    # [wsj otf 20k]: the accuracy of the main path's wave (the wave
    # `wsj_otf.decode_batch` decodes, not decoded again) and `wsj_otf`'s
    # oracle check, `RefOtfDecoder` on one short held-out utterance (seed
    # 12, ~150 frames: `wsj_otf --parity 1`)
    ed = wsj_bench.accuracy(results, utts, labels, markers)
    _, x_par = wsj_task.sample_utterances(task.cache, models, n_utts=1, target_frames=150,
                                          seed=p["seed"] + 1)[0]
    n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    t0 = time.perf_counter()
    n_exact = wsj_otf.parity(dec, task.net, g, models, [scorer(torch.as_tensor(x_par, device=dev))])
    t_par = time.perf_counter() - t0
    par_launches = (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])
    if n_exact != 1 or par_launches[1] or ed.accuracy != 1.0:
        raise RuntimeError(f"[wsj otf 20k] oracle parity {n_exact}/1, frame_step launches "
                           f"{par_launches[1]}, accuracy {ed.accuracy}")
    print(f"[wsj otf 20k] wsj_otf.tune (route {fused_scan.route_of(dec)[0]}) and the main "
          f"path's accuracy {ed.accuracy:.4f} ({ed.n_ref} words); RefOtfDecoder on the "
          f"{x_par.shape[0]}-frame held-out utterance: words exact ({t_par:.1f}s, launches "
          f"gmm_logsumexp {par_launches[0]}, frame_step {par_launches[1]}) | {card}", flush=True)
    scores = scorer(x).view(B, Tmax, G)
    # [wsj otf 20k]: `wsj_otf`'s steady bench (`steady_bench(g_network=)`)
    # on the main path's scores: the plain loop with the G, overflow read
    # from the timed wave
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    sb = wsj_bench.steady_bench(art, tuned, scores, [B], g_network=g, device=dev)[B]
    sb_launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if (sb["overflow"] or sb_launches != (0, 0)
            or not sb["route"].startswith("plain loop: on-the-fly composition")):
        raise RuntimeError(f"[wsj otf 20k] steady bench {sb}, launches {sb_launches}")
    print(f"[wsj otf 20k] steady_bench(g_network=) B={B} x {Tmax}: {sb['fps']:.1f} frames/s "
          f"(first wave {sb['compile_s']}s, overflow 0/{B}, route {sb['route']}; launches "
          f"gmm_logsumexp 0, frame_step 0: the scores are given) | {card}", flush=True)
    prof = plain_loop_profile(dec, scores)
    ms_frame, fps = t_entry * 1e3 / Tmax, B * Tmax / t_entry
    print(f"[otf] main path: BatchDecoder(use_fused=False), B={B} x {Tmax} frames at K="
          f"{dec.K} E={dec.E} F={dec.F}, two waves; launches: gmm_logsumexp {launches[0]}, "
          f"frame_step {launches[1]}; first wave {t_cert:.3f}s; 'auto' raises ({why})",
          flush=True)
    print(f"[otf] main path: timed wave {t_entry:.3f}s = {ms_frame:.3f} ms a frame step, "
          f"{fps:.1f} frames/s at the entry point (GMM kernel + plain frame loop + copy + "
          f"traceback); over 20 frames {prof['wall_ms']:.3f} ms a frame step, "
          f"{prof['launches_per_frame']:.2f} kernel launches and {prof['kernel_ms']:.4f} ms of "
          f"kernels a frame step, device idle share {prof['idle']:.3f}; the static 20k plain "
          f"loop of this call at B={static['B']}: {static['plain_ms_frame']:.3f} ms a frame "
          f"step over its wave, {static['wall_ms']:.3f} over 20 frames, "
          f"{static['launches_per_frame']:.2f} launches and {static['kernel_ms']:.4f} ms of "
          f"kernels a frame step, idle share {static['idle']:.3f}; its fused entry point "
          f"{static['entry_fps']:.1f} frames/s | {card}", flush=True)
    phase_done("otf main path")

    # ---- pushing: the same batch -------------------------------------------
    pdec = TorchDecoder(art, dataclasses.replace(tuned, emit_diagnostics=True,
                                                 otf_pushing=True), device="cuda", g_network=g)
    t0 = time.perf_counter()
    pushed = BatchDecoder(pdec, use_fused=False).decode_scores_batch(scores, lengths)
    t_push = time.perf_counter() - t0
    certify(pushed, "otf pushing", utts, labels, markers)
    # pushing moves LM weight earlier, which changes the per-frame
    # normalisers, and an utterance's LM is read back as score - ac + norm:
    # in float32 the cumulative normaliser (|norm| ~ |ac| ~ 6.6e4 here)
    # rounds at each frame, so two decodes whose normalisers differ part
    # by a few float32 spacings at |ac| (2 measured on this batch). The
    # float32 check allows 8; float64 holds the same batch to 1e-6 below
    PUSH_SPACINGS = 8
    worst, d32 = 0.0, 0.0
    for i, (a, r) in enumerate(zip(pushed, results)):
        if a.words != r.words:
            raise RuntimeError(f"[otf] pushing: utterance {i}'s words differ from plain OTF's")
        d = max(abs(a.acoustic_score - r.acoustic_score), abs(a.lm_score - r.lm_score))
        d32 = max(d32, d)
        worst = max(worst, d / float(np.spacing(np.float32(abs(r.acoustic_score)))))
    if not worst <= PUSH_SPACINGS:
        raise RuntimeError(f"[otf] pushing: float32 scores differ by {worst} spacings at "
                           f"|acoustic| (limit {PUSH_SPACINGS})")
    res64 = [BatchDecoder(TorchDecoder(art, dataclasses.replace(
        tuned, dtype="float64", emit_diagnostics=True, otf_pushing=push), device="cuda",
        g_network=g), use_fused=False).decode_scores_batch(scores, lengths)
             for push in (False, True)]
    certify(res64[1], "otf pushing float64", utts, labels, markers)
    d64 = 0.0
    for i, (a, r) in enumerate(zip(res64[1], res64[0])):
        if a.words != r.words:
            raise RuntimeError(f"[otf] pushing float64: utterance {i}'s words differ")
        d64 = max(d64, abs(a.acoustic_score - r.acoustic_score), abs(a.lm_score - r.lm_score))
    if not d64 <= 1e-6:
        raise RuntimeError(f"[otf] pushing float64: scores differ by {d64}")
    print(f"[otf] pushing: words equal plain OTF's; float32: acoustic and LM scores within "
          f"{d32} ({worst:.4f} float32 spacings at |acoustic|, limit {PUSH_SPACINGS}; |acoustic| up to "
          f"{max(abs(r.acoustic_score) for r in results):.1f}); float64, the same batch: "
          f"certified, words equal, scores within {d64:.3e} (limit 1e-6); float32 wave "
          f"{t_push:.3f}s = {t_push * 1e3 / Tmax:.3f} ms a frame step | {card}", flush=True)
    del pdec, pushed, res64, scores
    phase_done("otf pushing")

    # ---- card = CPU on a whole sentence, float32 and float64 ---------------
    words_s, xs = wsj_task.sample_utterances(
        task.cache, models, n_utts=2, target_frames=250, seed=12)[1]
    sc_card = scorer(torch.as_tensor(xs, device=dev))
    Ts = int(sc_card.shape[0])
    transcript = [labels[w] for w in words_s]
    for dtype in ("float32", "float64"):
        vcfg = dataclasses.replace(tuned, dtype=dtype)
        on_card = TorchDecoder(art, vcfg, device="cuda", g_network=g)
        on_cpu = TorchDecoder(art, vcfg, device="cpu", g_network=g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = host_batch(*on_card.run(on_card.scores_tensor(sc_card)[None]))
        t_card = time.perf_counter() - t0
        want = host_batch(*on_cpu.run(on_cpu.scores_tensor(sc_card.cpu())[None]))
        try:
            host_planes_diff(got, want, 0.0)
        except ValueError as e:
            print(f"[otf] card = CPU {dtype}: DIFFERS {e}", flush=True)
            raise RuntimeError(f"[otf] card = CPU {dtype}: the card differs from the CPU") from e
        r_card, r_cpu = on_card.traceback(got, 0, Ts), on_cpu.traceback(want, 0, Ts)
        ok_words = [w for w in r_card.words if w not in markers] == transcript
        if r_card.words != r_cpu.words or frames_of(r_card) != frames_of(r_cpu) or not ok_words:
            raise RuntimeError(f"[otf] card = CPU {dtype}: words differ or miss the transcript")
        print(f"[otf] card = CPU {dtype}: seed-12 sentence, {Ts} frames, every plane of run "
              f"equal (floats within 0.0), {len(r_card.words)} words equal and the transcript; card "
              f"{t_card * 1e3 / Ts:.3f} ms a frame | {card}", flush=True)
        del on_card, on_cpu, got, want
    phase_done("otf card=cpu")

    lat = lattice_phase("20k", art, tuned, scorer, torch.as_tensor(xs), card,
                        against_cpu=False, g=g)
    phase_done("otf lattice")

    # ---- the stream, plain loop --------------------------------------------
    whole = dec.decode_scores(sc_card, use_fused=False)
    stream = dec.stream(use_fused=False)
    emitted, per_chunk = [], []
    for i in range(0, Ts, STREAM_CHUNK):
        new = stream.feed(sc_card[i:i + STREAM_CHUNK])
        emitted += new
        per_chunk.append(len(new))
    fin = stream.finish()
    hyps = [(h.word, h.end_frame) for h in fin.word_hyps]
    if [(h.word, h.end_frame) for h in emitted] != hyps[:len(emitted)]:
        raise RuntimeError("[otf] stream: a partial emission is not a prefix of the final words")
    if not same_result(fin, whole) or fin.empty:
        raise RuntimeError("[otf] stream: finish() differs from the whole decode")
    print(f"[otf] stream: {Ts} frames in {len(per_chunk)} chunks of {STREAM_CHUNK} "
          f"(use_fused=False); words emitted per chunk {per_chunk} ({len(emitted)} of "
          f"{len(fin.words)} before finish), each a prefix of the final words; finish() "
          f"equal to the whole decode (words, word-end frames, score)", flush=True)
    phase_done("otf stream")
    return {
        "cli": dict(utts=utts, results=results, markers=markers, tuned=tuned),
        # the 20k pair, for [profile otf step]
        "pair": (art, g, models, task.cache),
        "gmm_logsumexp": {"launches_otf": launches[0], "ms_otf": gmm8["ms"],
                          "max_abs_err_otf": gmm8["err"], "launches_wsj_otf": par_launches[0]},
        "frame_step": {"launches_otf": launches[1], "launches_wsj_otf": par_launches[1],
                       "wsj_otf_steady_fps": sb["fps"], "otf_plain_ms_frame": ms_frame,
                       "otf_launches_per_frame": prof["launches_per_frame"],
                       "otf_plain_kernel_ms_frame": prof["kernel_ms"],
                       "otf_plain_idle": prof["idle"], "otf_lattice_ms_frame": lat["ms"]},
    }


# ---- the reference-scale tools of harness/ ----------------------------------
# [wsj sweep 20k]'s rungs: two on the tracked models, tuned from the bench's
# budgets, and one hard rung (free text, decode-side mismatch 1.5, the JAX
# sweep's default budgets) expected past the kernel's shared memory. At the
# full 8 x 1000 frames the hard rung took 82.5 and 105.5 s of plain loop (69
# s of it tuning: three probes up to K=8192); past 90 s it runs on 4
# utterances of ~300 frames
SWEEP_EASY = ["--settings", "70,50,500;60,40,300", "--K", "1024", "--E", "1408",
              "--batches", "8"]
SWEEP_HARD = ["--settings", "100,75,1200", "--free-text", "--mismatch", "1.5",
              "--batch", "4", "--frames", "300", "--batches", "4"]


def phase_wsj_bench_20k(card, task, tuned, want, phase_done):
    """[wsj bench 20k]: `harness/wsj_bench`'s main path on [20k]'s task and
    artifact at `WSJ_POINT`'s beams, tuned from its budgets over the 8
    seed-11 utterances: the tuned K and E equal [20k]'s (`tuned`), every
    utterance's words equal [20k]'s results (`want`) and the transcript;
    overflow 0/8, dead 0/8; the steady bench at B=8 and B=16 on the kernel
    route, overflow 0; the float32 engine's parity with the oracle on the
    two short utterances reported, then `--parity-only`: the float64
    engine's words exact and scores within 1e-6. Returns the kernels
    line's fields."""
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.harness import wsj_bench, wsj_task
    from juicer_tpu_torch.ops import gmm_cuda

    p = wsj_task.WSJ_POINT
    argv = ["--beam", str(p["beam"]), "--end-beam", str(p["end_beam"]), "--maxhyps",
            str(p["maxhyps"]), "--K", str(p["K"]), "--E", str(p["E"]), "--batch",
            str(p["n_utts"]), "--frames", str(p["frames"])]
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    out = wsj_bench.run(wsj_bench.parse_args(argv), task.net, task.models, task.artifact,
                        task.cache, bench_sizes=[8, 16])
    t_main = time.perf_counter() - t0
    launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    got, bench, res = out["tuned"], out["bench"], out["results"]
    if (got.max_insts, got.expand_budget) != (tuned.max_insts, tuned.expand_budget):
        raise RuntimeError(f"[wsj bench 20k] tuned K={got.max_insts} E={got.expand_budget}, "
                           f"[20k] K={tuned.max_insts} E={tuned.expand_budget}")
    for i, (r, w) in enumerate(zip(res, want)):
        if r.words != w.words:
            raise RuntimeError(f"[wsj bench 20k] utterance {i}'s words differ from [20k]'s")
    n_ov, dead = sum(r.overflow for r in res), sum(r.empty for r in res)
    if out["route"] != "frame_step" or n_ov or dead or out["accuracy"].accuracy != 1.0:
        raise RuntimeError(f"[wsj bench 20k] route {out['route']}, overflow {n_ov}, dead "
                           f"{dead}, accuracy {out['accuracy'].accuracy}")
    for b, rec in bench.items():
        if rec["overflow"] or rec["route"] != "frame_step":
            raise RuntimeError(f"[wsj bench 20k] steady B={b}: {rec}")
    n_f32 = sum(out["parity_exact"])
    print(f"[wsj bench 20k] wsj_bench.run at WSJ_POINT's beams, tuned from K={p['K']} "
          f"E={p['E']}: K={got.max_insts} E={got.expand_budget} (= [20k]'s), route "
          f"{out['route']}; {len(res)} utterances: words = [20k]'s, overflow {n_ov}/{len(res)}, "
          f"dead {dead}/{len(res)}, accuracy {out['accuracy'].accuracy:.4f}; steady bench "
          f"B=8 {bench[8]['fps']:.1f} and B=16 {bench[16]['fps']:.1f} frames/s (overflow "
          f"0, first waves {bench[8]['compile_s']} / {bench[16]['compile_s']} s); oracle "
          f"{sum(t for _, t in out['oracles']):.1f}s for 2 utterances, the float32 engine's "
          f"words equal its on {n_f32} of 2 (reported; float32 sums may flip a near-tie); "
          f"launches gmm_logsumexp "
          f"{launches[0]}, frame_step {launches[1]}; {t_main:.1f}s | {card}", flush=True)
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    wsj_bench.run(wsj_bench.parse_args(argv + ["--parity-only"]), task.net, task.models,
                  task.artifact, task.cache)
    f64_launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if f64_launches[1]:
        raise RuntimeError("[wsj bench 20k] the float64 parity launched frame_step")
    print(f"[wsj bench 20k] --parity-only: the float64 engine (plain loop on the card) "
          f"equals the oracle on 2 utterances (words exact, scores within 1e-6); "
          f"{time.perf_counter() - t0:.1f}s | {card}", flush=True)
    phase_done("wsj bench 20k")
    return {"gmm_logsumexp": {"launches_wsj_bench": launches[0] + f64_launches[0]},
            "frame_step": {"launches_wsj_bench": launches[1], "wsj_bench_fps_b8":
                           bench[8]["fps"], "wsj_bench_fps_b16": bench[16]["fps"]}}


def phase_wsj_sweep_20k(card, task, phase_done):
    """[wsj sweep 20k]: `harness/wsj_sweep` on [20k]'s task and artifact, one
    row a rung with its route: `SWEEP_EASY`'s two rungs on the tracked
    models must certify on the kernel route (overflow 0, dead 0, the bench
    wave's overflow 0; accuracy reported); `SWEEP_HARD`'s rung prints its
    route and reason (expected: the plain loop, past the kernel's shared
    memory). Returns the kernels line's fields."""
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.harness import wsj_sweep
    from juicer_tpu_torch.ops import gmm_cuda

    launches = [0, 0]
    rows = {}
    for what, argv in (("easy", SWEEP_EASY), ("hard", SWEEP_HARD)):
        gmm_cuda.counter.launches = 0
        fused_scan.counter.launches = 0
        t0 = time.perf_counter()
        last = wsj_sweep.sweep(wsj_sweep.parse_args(argv), task.net, task.artifact,
                               task.cache)
        n = (gmm_cuda.counter.launches, fused_scan.counter.launches)
        launches[0] += n[0]
        launches[1] += n[1]
        for row in last["rows"]:
            spec = f"{row['beam']:g},{row['end_beam']:g},{row['maxhyps']}"
            rows[spec] = row
            if "error" in row:
                print(f"[wsj sweep 20k] {spec}: FAILED ({row['error']}); route {row['route']}",
                      flush=True)
            else:
                (bs, b), = row["bench"].items()
                print(f"[wsj sweep 20k] {spec} ({what}: free text {last['free_text']}, "
                      f"mismatch {last['mismatch']}): K={row['K']} E={row['E']}, accuracy "
                      f"{row['accuracy']:.4f} ({row['errors']} errors in {row['n_words']} "
                      f"words), peak {row['peak_active']}, overflow {row['overflow']}, dead "
                      f"{row['dead']}, steady B={bs} {b['fps']:.1f} frames/s (overflow "
                      f"{b['overflow']}, first wave {b['compile_s']}s); route {row['route']} "
                      f"| {card}", flush=True)
            if what == "easy" and ("error" in row or row["route"] != "frame_step"
                                   or row["overflow"] or row["dead"]
                                   or any(b["overflow"] for b in row["bench"].values())):
                raise RuntimeError(f"[wsj sweep 20k] {spec} did not certify on the kernel "
                                   f"route: {row}")
        print(f"[wsj sweep 20k] {what}: {time.perf_counter() - t0:.1f}s, launches "
              f"gmm_logsumexp {n[0]}, frame_step {n[1]} | {card}", flush=True)
        phase_done(f"wsj sweep 20k {what}")
    return {"gmm_logsumexp": {"launches_wsj_sweep": launches[0]},
            "frame_step": {"launches_wsj_sweep": launches[1],
                           "wsj_sweep_routes": {k: r["route"] for k, r in rows.items()}}}


def phase_bench_otf(card, phase_done):
    """[bench otf]: `harness/bench_otf --quick` on the card: the word-loop
    task composed on the fly, with and without pushing, each certified on
    its distinct utterances (no overflow, words found); the plain loop (no
    frame_step launch). Returns the kernels line's fields."""
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.harness import bench_otf
    from juicer_tpu_torch.ops import gmm_cuda

    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    out = bench_otf.run(quick=True, device="cuda")
    n = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if n[1] or not out["route"].startswith("plain loop: on-the-fly composition"):
        raise RuntimeError(f"[bench otf] route {out['route']}, frame_step launches {n[1]}")
    for name in ("otf", "otf (pushing)"):
        fps, certified, results = out[name]
        if not certified:
            raise RuntimeError(f"[bench otf] {name}: not certified")
        print(f"[bench otf] {name}: {fps:.1f} frames/s (--quick: B=8 x 128 frames of a "
              f"30-word loop, GMM kernel + plain loop; a check that it runs, bound by the "
              f"host, not a throughput), {len(results)} distinct utterances certified | "
              f"{card}", flush=True)
    print(f"[bench otf] route {out['route']}; launches gmm_logsumexp {n[0]}, frame_step "
          f"{n[1]}; {time.perf_counter() - t0:.1f}s | {card}", flush=True)
    phase_done("bench otf")
    return {"gmm_logsumexp": {"launches_bench_otf": n[0]},
            "frame_step": {"launches_bench_otf": n[1]}}


# ---- the repo's last tools: scale_bench, pipeline_scale, the two step
# ablations, the Mosaic probe's patterns and the graft entry ------------------
# pipeline_scale's arcs at 200 and 1000 words (L, G, L o G, det, min), the JAX
# script's and the port's alike (tests/test_torch_pipeline_scale.py)
PIPELINE_ARCS = {200: (1165, 1000, 3125, 12293, 12013),
                 1000: (5960, 5000, 15869, 102981, 100796)}
SCALE_KERNEL_KE = (768, 1024)  # at G=6,000: fits a block's shared memory
SCALE_PLAIN_KE = (1024, 1408)  # the bench's budgets: past it at G=6,000
SCALE_B = 8


def phase_scale_1m(card, dev, gmm141, phase_done):
    """[scale 1M]: `harness/scale_bench` at its 1,000,000 arcs and 6,000
    GMMs (see the module docstring). `gmm141` is [gmm] B=16's record (G=141),
    printed beside the G=6,000 reading. Returns the kernels line's fields."""
    import numpy as np
    import torch

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.decoder.core import TorchDecoder, host_batch
    from juicer_tpu_torch.decoder.fused_scan import FusedDecodeScan
    from juicer_tpu_torch.harness import scale_bench
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.ops.gmm import make_gmm_scorer

    net, models, art, secs = scale_bench.build()
    ex = art.expansion
    G = models.n_gmms
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    TorchDecoder(art, scale_bench.decoder_config(), device=dev)
    torch.cuda.synchronize()
    table_bytes = torch.cuda.memory_allocated() - m0
    print(f"[scale 1M] network {net.n_states} states / {net.n_arcs} arcs "
          f"{secs['network_s']:.1f}s, models {models.n_hmms} HMMs / {G} GMMs "
          f"{secs['models_s']:.1f}s, artifact {art.n_hmm_arcs} HMM arcs, {len(ex.arc)} closure "
          f"entries, largest fan-out {int(np.diff(ex.row_ptr).max())}, "
          f"{secs['artifact_s']:.1f}s; tables on the card {table_bytes} bytes | {card}",
          flush=True)
    phase_done("scale 1M build")

    # B=1 at the script's defaults (K=8192 / E=32768): the plain loop
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    b1 = scale_bench.run(scale_bench.parse_args([]), (net, models, art))
    n_b1 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if not b1["route"].startswith("plain loop: ") or n_b1 != (0, 0):
        raise RuntimeError(f"[scale 1M] B=1 at K=8192 / E=32768: route {b1['route']}, "
                           f"launches {n_b1}; expected the plain loop, (0, 0)")
    s = b1["single"]
    print(f"[scale 1M] B=1 K={b1['decoder'].K} E={b1['decoder'].E}: route {b1['route']}; "
          f"{len(s['result'].words)} words, overflow {s['result'].overflow}; first call "
          f"{s['first_s']:.2f}s, steady {s['steady_s']:.2f}s = "
          f"{scale_bench.FRAMES / s['steady_s']:.1f} frames/s; launches gmm_logsumexp "
          f"{n_b1[0]}, frame_step {n_b1[1]} | {card}", flush=True)
    del b1, s
    phase_done("scale 1M B=1")

    # --batch 8 at K=768 / E=1024 through the kernel, then held to the plain loop
    K, E = SCALE_KERNEL_KE
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    b8 = scale_bench.run(scale_bench.parse_args(
        [str(net.n_arcs), str(K), str(E), "--batch", str(SCALE_B)]), (net, models, art))
    n_b8 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if b8["route"] != "frame_step" or n_b8 != (0, 2):
        raise RuntimeError(f"[scale 1M] --batch {SCALE_B} at K={K} / E={E}: route "
                           f"{b8['route']}, launches {n_b8}; expected frame_step, (0, 2)")
    dec, w = b8["decoder"], b8["batch"]
    T = scale_bench.FRAMES
    scores = dec.scores_tensor(scale_bench.score_batch(SCALE_B, G))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_state = dec.run(scores)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    host = host_batch(*plain_state)
    plain_results = [dec.traceback(host, b, T) for b in range(SCALE_B)]
    del host
    fs = FusedDecodeScan(dec, SCALE_B)
    scores_tbg = scores.transpose(0, 1).contiguous()
    fused_state, float_err, _ = hold_to_plain("scale 1M", dec, fs, scores_tbg, plain_state,
                                           plain_results, [T] * SCALE_B)
    n_cand, n_active, n_rec = wave_counts(fused_state[1])
    del plain_state, fused_state
    fs_ms = cuda_ms(lambda: fs(scores_tbg), 3)
    bound, bound_by, nbytes, ops, _ = frame_step_bound(dec, SCALE_B, T, scores_tbg.numel(),
                                                       n_cand, n_active, n_rec)
    need = fused_scan.smem_bytes(**fs.dims)
    print(f"[scale 1M] --batch {SCALE_B} K={dec.K} E={dec.E} (G={G}: {need} bytes of shared "
          f"memory a block of {fused_scan.SMEM_LIMIT}): route {b8['route']}, launches "
          f"gmm_logsumexp {n_b8[0]}, frame_step {n_b8[1]}; first wave {w['first_s']:.3f}s, "
          f"steady {w['steady_s']:.4f}s = {SCALE_B * T / w['steady_s']:.1f} frames/s/card, "
          f"overflow {int(w['overflow'].sum())}/{SCALE_B} (the budgets bind by design); the "
          f"kernel equals the plain loop bit for bit on that wave (records, snapshots, carry, "
          f"words; max |float diff| {float_err}) | {card}", flush=True)
    print(f"[scale 1M] frame_step {fs_ms:.3f} ms a wave of {SCALE_B} x {T} "
          f"({fs_ms * 1e3 / T:.2f} us a frame), plain loop {plain_ms:.1f} ms, bound "
          f"{bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations; "
          f"{n_cand} candidates, {n_active} active slot-frames, {n_rec} records) | {card}",
          flush=True)
    # one utterance at these budgets: decode_scores through the kernel (one
    # launch) against decode_scores on the plain loop
    sc1 = scores[0]
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    r_kernel = dec.decode_scores(sc1)
    n_one = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    r_plain = dec.decode_scores(sc1, use_fused=False)
    if n_one != (0, 1) or not same_result(r_kernel, r_plain):
        raise RuntimeError(f"[scale 1M] B=1 at K={K} / E={E}: launches {n_one}, kernel words "
                           f"{r_kernel.words} score {r_kernel.score} vs plain {r_plain.words} "
                           f"{r_plain.score}")
    print(f"[scale 1M] B=1 K={dec.K} E={dec.E}: decode_scores through frame_step (one launch) "
          f"equals the plain loop: {len(r_kernel.words)} words, score {r_kernel.score:.4f}, "
          f"dead {r_kernel.empty}, overflow {r_kernel.overflow} | {card}", flush=True)
    del scores, scores_tbg, sc1, fs, b8, dec

    K2, E2 = SCALE_PLAIN_KE
    wide = TorchDecoder(art, scale_bench.decoder_config(K2, E2), device=dev)
    why = fused_scan.why_not_fused(wide)
    if why is None or "shared memory" not in why:
        raise RuntimeError(f"[scale 1M] K={K2} / E={E2} at G={G}: why_not_fused {why!r}")
    print(f"[scale 1M] K={K2} / E={E2} at G={G} takes the plain loop: {why}", flush=True)
    del wide
    phase_done("scale 1M B=8")

    # the GMM kernel at G=6,000 on 8 x 500 frames of features
    scorer = make_gmm_scorer(models.flat_params(), device="cuda")
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.normal(size=(SCALE_B * T, 39)).astype(np.float32), device=dev)
    g6k = gmm_phase(scorer, x, f"scale G={G} B={SCALE_B}", card)
    print(f"[scale 1M] gmm_logsumexp at G={G}: {g6k['ms']:.4f} ms for {SCALE_B * T} frames, "
          f"{100 * g6k['bound_ms'] / g6k['ms']:.1f} % of its bound, library "
          f"{g6k['library_ms']:.4f} ms; at G=141 ([gmm] B=16, 23,328 frames) "
          f"{gmm141['ms']:.4f} ms, {100 * gmm141['bound_ms'] / gmm141['ms']:.1f} % of its "
          f"bound | {card}", flush=True)
    del scorer, x, art, net, models
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("scale 1M gmm")
    return {"gmm_logsumexp": {"launches_scale_b1": n_b1[0], "launches_scale_b8": n_b8[0],
                              "max_abs_err_g6000": g6k["err"], "ms_g6000": g6k["ms"],
                              "plain_ms_g6000": g6k["plain_ms"],
                              "bound_ms_g6000": g6k["bound_ms"],
                              "library_ms_g6000": g6k["library_ms"]},
            "frame_step": {"launches_scale_b1": n_b1[1], "launches_scale_b8": n_b8[1],
                           "ms_scale_b8": fs_ms, "plain_ms_scale_b8": plain_ms,
                           "bound_ms_scale_b8": bound, "bound_by_scale_b8": bound_by,
                           "max_abs_err_scale_b8": float_err}}


def phase_pipeline_scale(card, phase_done):
    """[pipeline scale]: `harness/pipeline_scale` at 200 and 1000 words on
    the host; every machine's arcs equal `PIPELINE_ARCS`."""
    import tempfile

    from juicer_tpu_torch.harness import pipeline_scale

    for n_words, want in PIPELINE_ARCS.items():
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            out = pipeline_scale.run_size(tmp, n_words)
        m = out["machines"]
        got = tuple(m[k].num_arcs for k in ("L", "G", "LG", "det", "min"))
        if got != want:
            raise RuntimeError(f"[pipeline scale] {n_words} words: arcs {got}, expected {want}")
        print(f"[pipeline scale] {n_words} words: L, G, L o G, det, min arcs {got} (expected); "
              f"stages " + ", ".join(f"{k} {v:.2f}s" for k, v in out["seconds"].items())
              + f"; {time.perf_counter() - t0:.1f}s in all (host) | {card}", flush=True)
    phase_done("pipeline scale")


def phase_profile_step(card, phase_done):
    """[profile step]: `harness/profile_step` cut to B=16 x 200 frames and
    one timed iteration: the full line on both routes (the kernel's best
    finals equal the plain loop's bit for bit; two frame_step launches, the
    warm-up and the timed one) and the three ablations on the plain loop.
    Returns the kernels line's fields."""
    import numpy as np

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.harness import profile_step
    from juicer_tpu_torch.ops import gmm_cuda

    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    out = profile_step.run(profile_step.parse_args(["16", "--frames", "200", "--iters", "1"]))
    n = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if n != (0, 2) or out["full (frame_step)"]["route"] != "frame_step":
        raise RuntimeError(f"[profile step] launches {n}, expected (0, 2)")
    if not np.array_equal(out["full"]["best_final"], out["full (frame_step)"]["best_final"]):
        raise RuntimeError("[profile step] the kernel's best finals differ from the plain loop's")
    print(f"[profile step] B=16 x 200: plain loop {out['full']['s'] * 1e3:.1f} ms, frame_step "
          f"{out['full (frame_step)']['s'] * 1e3:.1f} ms a wave (best finals equal bit for "
          f"bit); " + ", ".join(f"{label} {out[label]['s'] * 1e3:.1f} ms"
                                for label, _ in profile_step.ABLATIONS)
          + f"; {out['sorts']} sort calls a frame step; launches gmm_logsumexp {n[0]}, "
          f"frame_step {n[1]} | {card}", flush=True)
    phase_done("profile step")
    return {"gmm_logsumexp": {"launches_profile_step": n[0]},
            "frame_step": {"launches_profile_step": n[1]}}


def phase_profile_otf_step(card, dev, pair, phase_done):
    """[profile otf step]: `harness/profile_otf_step` on [otf]'s 20k pair
    (`pair` = artifact, G, models, task directory), cut to 8 utterances of
    ~200 frames and one timed wave a line: every line the plain loop (no
    frame_step launch), the GMM kernel once an utterance. Returns the
    kernels line's fields."""
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.harness import profile_otf_step
    from juicer_tpu_torch.ops import gmm_cuda

    art, g, models, cache = pair
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    db = profile_otf_step.batch_scores(cache, models, 8, dev, frames=200)
    out = profile_otf_step.profile(art, g, db, waves=1, card=card)
    n = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    if n != (8, 0) or any(not out[k]["route"].startswith("plain loop: ") for k in out):
        raise RuntimeError(f"[profile otf step] launches {n} (expected (8, 0)), routes "
                           f"{[out[k]['route'] for k in out]}")
    print(f"[profile otf step] B=8 x {db.shape[1]} frames, K=2176 / E=3840: " + ", ".join(
        f"{k} {out[k]['fps']:.1f} frames/s (overflow {out[k]['overflow']})" for k in out)
        + f"; launches gmm_logsumexp {n[0]}, frame_step {n[1]} | {card}", flush=True)
    phase_done("profile otf step")
    return {"gmm_logsumexp": {"launches_profile_otf_step": n[0]},
            "frame_step": {"launches_profile_otf_step": n[1]}}


def probe_bound(rec):
    """(bound ms, bound_by) of one probe of `harness/pallas_probe` on its
    own inputs: each input byte the pattern needs read once (for a gather,
    the table's distinct rows it reads), each output byte written once."""
    import types

    from juicer_tpu_torch.harness import pallas_probe

    # the probe's kernel call and its arguments, caught on the plain versions
    seen = []

    def spy(op):
        def call(*args):
            seen.append((op, args))
            return getattr(pallas_probe.PLAIN, op)(*args)
        return call

    pallas_probe.PROBES[rec["name"]][2](
        types.SimpleNamespace(**{op: spy(op) for op in ("product", "gather", "extract")}),
        rec["inputs"])
    (op, args), = seen
    ops = 0.0
    if op == "product":
        x, t = args
        nbytes = 4.0 * (x.numel() + t.numel() + x.shape[0] * t.shape[1])
        ops = 2.0 * x.shape[0] * x.shape[1] * t.shape[1]
    elif op == "gather":
        idx, tab = args
        nbytes = 4.0 * (idx.numel() + int(idx.unique().numel()) * tab.shape[1]
                        + idx.numel() * tab.shape[1])
    else:
        x, r0, n, c0, m = args
        nbytes = 8.0 * n * m
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def phase_pallas_probe(card, dev, phase_done):
    """[pallas probe]: `harness/pallas_probe` on the card, all nine probes:
    each kernel equal to its plain version (exactly for D-I, within 1e-5
    relative for A-C); the launches of each of the three kernels counted over
    the tool's run (the probes' first calls and the tool's own timing); per
    probe the bound (`probe_bound`) beside the tool's device times a call
    (the host takes longer to issue a call than these kernels run): the
    kernel, one PyTorch call of the same function (`pallas_probe.LIBRARY`:
    `torch.matmul`, `index_select` after the cast of the float indices, the
    slice's `clone`) and the two yardsticks, the floor (a kernel that does
    nothing) and one float read and written, all four in one profiler
    session since a session's device times can read ~2.8x those of the
    next; the plain version's in a session of its own; each with the timer
    it took. Each product probe's kernel beside `torch.matmul` on a line of
    its own, each copy's (D, F, G, H) beside the slice's `clone` on
    another. Returns the kernels line's `probe_patterns` entry."""
    from juicer_tpu_torch.harness import pallas_probe
    from juicer_tpu_torch.ops import probe_cuda

    for c in probe_cuda.counters.values():
        c.launches = 0
    records = pallas_probe.run(dev, card=card)
    launches = {k: c.launches for k, c in probe_cuda.counters.items()}
    calls = {k: sum(r["calls"] for r in records if r["kernel"] == k) for k in launches}
    failed = [r["name"] for r in records if not r["ok"]]
    if failed or len(records) != 9 or not all(launches.values()) or launches != calls:
        raise RuntimeError(f"[pallas probe] failed {failed}, launches {launches}, "
                           f"wrapper calls {calls}")
    probes = []
    for r in records:
        bound, bound_by = probe_bound(r)
        timers = {"kernel, library, yardsticks": r["timer"], "plain": r["plain_timer"]}
        probes.append({"name": r["name"], "kernel": r["kernel"], "max_abs_err": r["err"],
                       "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound,
                       "bound_by": bound_by, "library_ms": r["library_ms"],
                       "floor_ms": r["floor_ms"], "one_float_ms": r["one_float_ms"],
                       "timers": timers, "events_ms": r["events_ms"],
                       "plain_events_ms": r["plain_events_ms"]})
        print(f"[pallas probe] {r['name']} ({r['kernel']}): device time a call: kernel "
              f"{r['ms']:.5f} ms, library {r['library_ms']:.5f} ms, floor {r['floor_ms']:.5f} "
              f"ms, one float {r['one_float_ms']:.5f} ms (one session); plain "
              f"{r['plain_ms']:.5f} ms (alone; timers {timers}); bound {bound:.3e} ms "
              f"({bound_by}); a call in a stream (host-issue bound): kernel "
              f"{r['events_ms']:.4f} ms, plain {r['plain_events_ms']:.4f} ms | {card}",
              flush=True)
    for kernel, library in (("probe_product", "torch.matmul"),
                            ("probe_extract", "the slice's clone")):
        print(f"[pallas probe] {kernel} against {library}, device time a call in one "
              "session: " + "; ".join(
                  f"{p['name'][0]} {p['ms']:.5f} / {p['library_ms']:.5f} ms "
                  f"({p['ms'] / p['library_ms']:.2f}x)"
                  for p in probes if p["kernel"] == kernel) + f" | {card}", flush=True)
    per_probe = {r["name"]: r["calls"] for r in records}
    print(f"[pallas probe] 9 of 9 PASS; launches {launches}, one a wrapper call: {per_probe} "
          f"calls a probe (its first call and the tool's two timings) | {card}", flush=True)
    phase_done("pallas probe")
    return {"name": "probe_patterns", "route": "cuda",
            "source": "juicer_tpu_torch/csrc/probe_patterns.cu",
            "replaces": "scripts/pallas_probe.py:30",
            "launches": sum(launches.values()), "launches_by_kernel": launches,
            "max_abs_err": max(p["max_abs_err"] for p in probes),
            # the nine probes one after another (each probe's own is in "probes")
            "ms": sum(p["ms"] for p in probes), "plain_ms": sum(p["plain_ms"] for p in probes),
            "bound_ms": sum(p["bound_ms"] for p in probes), "bound_by": "bytes",
            "library_ms": sum(p["library_ms"] for p in probes),
            "floor_ms": sum(p["floor_ms"] for p in probes), "probes": probes}


def phase_graft_entry(card, dev, phase_done):
    """[graft entry]: `graft_entry.entry` on the card (one launch of each
    kernel) against `entry(device="cpu")` on the same features, best finals
    within 1e-3; `dryrun_multichip` over two replicas on the card, every
    check passing. Returns the kernels line's fields."""
    import numpy as np
    import torch

    from juicer_tpu_torch import graft_entry
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.utils.synth import make_synth_task

    fn, (example,) = graft_entry.entry(dev)
    cpu_fn, _ = graft_entry.entry("cpu")
    f = make_synth_task(n_words=30, n_phones=16, vec_size=20, seed=0).synth_utterance(
        ["w3", "w17"], np.random.default_rng(5))[:50]
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    got = float(fn(torch.as_tensor(f, device=dev)))
    n_entry = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    want = float(cpu_fn(torch.as_tensor(f)))
    ex_card, ex_cpu = float(fn(example)), float(cpu_fn(example.cpu()))
    if n_entry != (1, 1) or not (got > -1e29 and abs(got - want) <= graft_entry.SCORE_TOL):
        raise RuntimeError(f"[graft entry] card {got} vs cpu {want}, launches {n_entry}")
    if not (abs(ex_card - ex_cpu) <= graft_entry.SCORE_TOL or max(ex_card, ex_cpu) < -1e29):
        raise RuntimeError(f"[graft entry] example: card {ex_card} vs cpu {ex_cpu}")
    print(f"[graft entry] entry: {len(f)} frames, best final {got:.4f} on the card, {want:.4f} "
          f"on the CPU (|diff| {abs(got - want):.2e}, tol {graft_entry.SCORE_TOL}); the "
          f"example {ex_card:.4f} / {ex_cpu:.4f}; launches gmm_logsumexp {n_entry[0]}, "
          f"frame_step {n_entry[1]} | {card}", flush=True)
    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(2, device=dev, mesh=(dev, dev))
    n_dry = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    # gmm_logsumexp: the batch's scores and the WSJ-budget batch's; frame_step:
    # 4 single-device truths, 2 shares of the fused route, 2 gathered finals
    if n_dry != (2, 8):
        raise RuntimeError(f"[graft entry] dryrun_multichip launches {n_dry}, expected (2, 8)")
    print(f"[graft entry] dryrun_multichip(2) over (cuda:0, cuda:0): {len(out['plain'])} "
          f"utterances, routes {out['routes']}, mean best final {out['mean_best_final']:.3f}; "
          f"launches gmm_logsumexp {n_dry[0]}, frame_step {n_dry[1]}; "
          f"{time.perf_counter() - t0:.1f}s | {card}", flush=True)
    phase_done("graft entry")
    return {"gmm_logsumexp": {"launches_graft_entry": n_entry[0],
                              "launches_graft_dryrun": n_dry[0]},
            "frame_step": {"launches_graft_entry": n_entry[1],
                           "launches_graft_dryrun": n_dry[1]}}


# ---- the decoder CLI: its input files, written by the smoke -------------------
# The CLI reads text (AT&T FSM and symbol files, a text MMF, HTK features);
# the tasks are tracked as npz. These writers are the smoke's own: floats at
# float64 round-trip precision (`repr`), so what the CLI reads back equals
# the npz arrays bit for bit.

def _fmt_arcs(src, dst, il, ol, cost) -> str:
    return "".join(f"{a} {b} {c} {d} {w!r}\n" if w != 0.0 else f"{a} {b} {c} {d}\n"
                   for a, b, c, d, w in zip(src, dst, il, ol, cost))


def write_network_text(net, path):
    """A `DecoderNetwork` (LM scale 1, no insertion penalty: its weights are
    the negated costs) as AT&T text: the initial state's arcs first (the
    reader takes the first line's source as the initial state), the rest in
    CSR order, so the reader's stable sort by source gives the CSR back."""
    import numpy as np

    if net.lm_scale != 1.0 or net.ins_pen != 0.0:
        raise ValueError("the writer takes a network read at LM scale 1, no penalty")
    s0 = int(net.init_state)
    lo, hi = int(net.row_ptr[s0]), int(net.row_ptr[s0 + 1])
    order = np.concatenate([np.arange(lo, hi), np.arange(0, lo), np.arange(hi, net.n_arcs)])
    cols = [net.arc_src, net.arc_dst, net.arc_ilabel, net.arc_olabel]
    with open(path, "w") as fd:
        for i in range(0, len(order), 1 << 20):
            part = order[i:i + (1 << 20)]
            fd.write(_fmt_arcs(*(c[part].tolist() for c in cols),
                               (-net.arc_weight[part]).tolist()))
        for s in np.flatnonzero(net.final_weight > -1e30).tolist():
            cost = -float(net.final_weight[s])
            fd.write(f"{s} {cost!r}\n" if cost != 0.0 else f"{s}\n")


def write_fst_text(f, path):
    """An `Fst` (costs) as AT&T text at round-trip precision, in insertion
    order with the start state's arcs stable-sorted to the front."""
    import numpy as np

    src = np.asarray(f.arc_src)
    order = np.concatenate([np.flatnonzero(src == f.start), np.flatnonzero(src != f.start)])
    cols = [np.asarray(c)[order].tolist()
            for c in (f.arc_src, f.arc_dst, f.arc_ilabel, f.arc_olabel, f.arc_weight)]
    with open(path, "w") as fd:
        fd.write(_fmt_arcs(*cols))
        for s in sorted(f.finals):
            fd.write(f"{s} {f.finals[s]!r}\n" if f.finals[s] != 0.0 else f"{s}\n")


def write_models_text(models, path):
    """An `AcousticModelSet` as a text MMF: one ~t macro a transition
    matrix, one ~s macro a GMM (weights, means and variances at round-trip
    precision; probabilities are exp of the stored logs, which give the
    logs back bit for bit at these tasks), one ~h an HMM."""
    import numpy as np

    def vec(v):
        return " ".join(repr(float(x)) for x in v)

    def prob(logs):
        return np.where(np.asarray(logs) <= -1e30, 0.0, np.exp(logs))

    D = models.vec_size
    with open(path, "w") as fd:
        fd.write(f"~o <STREAMINFO> 1 {D} <VECSIZE> {D} <NULLD><DIAGC>\n")
        for t, tm in enumerate(models.trans_mats):
            fd.write(f'~t "T{t}"\n<TRANSP> {tm.shape[0]}\n')
            fd.write("".join(f" {vec(row)}\n" for row in prob(tm)))
        for g in range(models.n_gmms):
            w = prob(models.gmm_log_weights[g])
            fd.write(f'~s "S{g}"\n<NUMMIXES> {len(w)}\n')
            for c in range(len(w)):
                fd.write(f"<MIXTURE> {c + 1} {float(w[c])!r}\n<MEAN> {D}\n "
                         f"{vec(models.gmm_means[g][c])}\n<VARIANCE> {D}\n "
                         f"{vec(models.gmm_vars[g][c])}\n")
        for h, name in enumerate(models.hmm_names):
            n = models.get_num_states(h)
            fd.write(f'~h "{name}"\n<BEGINHMM>\n<NUMSTATES> {n}\n')
            for j, g in enumerate(models.hmm_gmm_inds[h]):
                fd.write(f'<STATE> {j + 2}\n~s "S{int(g)}"\n')
            fd.write(f'~t "T{models.hmm_trans_ind[h]}"\n<ENDHMM>\n')


def write_cli_task(td, cache, net, models, utts, names):
    """The CLI's files in directory td for task directory `cache`: the
    network (`net.fsm`), symbol files (model names in, vocabulary words
    out), the models (`models.mmf`), the lexicon, the utterances as HTK
    features under `names`, an input list and plain references (the
    transcript without sentence marks). Returns the common arguments and
    the seconds of the network's text."""
    import shutil

    from juicer_tpu_torch.fst import SymbolTable, write_symbols
    from juicer_tpu_torch.harness.features import write_htk
    from juicer_tpu_torch.lexicon import Vocabulary

    def j(name):
        return os.path.join(td, name)

    t0 = time.perf_counter()
    write_network_text(net, j("net.fsm"))
    t_net = time.perf_counter() - t0
    vocab = Vocabulary(os.path.join(cache, "lex.dict"), "!", "<s>", "</s>")
    write_symbols(SymbolTable(["<eps>", *models.hmm_names]), j("in.syms"))
    write_symbols(SymbolTable(["<eps>", *vocab.words]), j("out.syms"))
    write_models_text(models, j("models.mmf"))
    shutil.copy(os.path.join(cache, "lex.dict"), j("lex.dict"))
    for name, (_, feats) in zip(names, utts):
        write_htk(j(f"{name}.htk"), feats)
    with open(j("in.lst"), "w") as fd:
        fd.write("".join(f"{name}={j(name + '.htk')}\n" for name in names))
    with open(j("refs.txt"), "w") as fd:
        fd.write("".join(" ".join(f"w{w}" for w in words) + "\n" for words, _ in utts))
    argv = ["-lexFName", j("lex.dict"), "-sentStartWord", "<s>", "-sentEndWord", "</s>",
            "-fsmFName", j("net.fsm"), "-inSymsFName", j("in.syms"),
            "-outSymsFName", j("out.syms"), "-htkModelsFName", j("models.mmf"),
            "-inputFName", j("in.lst")]
    return argv, t_net


def check_network_read_back(what, got, want):
    """The CLI's network from text against the npz: every array equal;
    a marker that differs is printed with the reason (the symbol tables
    that built the npz are not tracked; the smoke's are rebuilt from the
    models and the vocabulary)."""
    import numpy as np

    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel", "arc_weight", "row_ptr",
              "final_weight"):
        a, b = getattr(got, k), getattr(want, k)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"[{what}] the network read from text differs from the npz "
                               f"in {k}")
    same, differ = [], []
    for k in ("n_states", "init_state", "word_end_marker", "sil_marker", "sp_marker"):
        (same if getattr(got, k) == getattr(want, k) else differ).append(k)
    for k in differ:
        print(f"[{what}] {k}: {getattr(got, k)} from the text and its symbol files, "
              f"{getattr(want, k)} in the npz (built from symbol tables that are not "
              f"tracked)", flush=True)
    return same, differ


def check_models_read_back(what, got, want):
    """The CLI's models from the text MMF against the npz: `flat_params`
    bit for bit (the GMM kernel's inputs) and the packed topology."""
    import numpy as np

    fg, fw = got.flat_params(), want.flat_params()
    for k in ("V", "M", "b"):
        a, b = getattr(fg, k), getattr(fw, k)
        if a.shape != b.shape or not np.array_equal(a.view(np.uint32), b.view(np.uint32)):
            raise RuntimeError(f"[{what}] flat_params().{k} from the MMF differs from the npz")
    if not np.array_equal(fg.mask, fw.mask):
        raise RuntimeError(f"[{what}] the component mask differs")
    for a, b in zip(got.packed_topology(), want.packed_topology()):
        if not np.array_equal(a, b):
            raise RuntimeError(f"[{what}] the HMM topology from the MMF differs from the npz")


def run_cli(argv):
    """`juicer_tpu_torch.cli.juicer` in this process (`main` is `run` with an
    exit code): the report, the launches of both kernels in the run, and
    the budget-overflow warnings the traceback gave."""
    import warnings

    from juicer_tpu_torch.cli import juicer
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.utils.log import LogFile

    gmm_cuda.counter.launches = 0
    fused_scan.counter.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        report = juicer.run(argv)
    launches = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    LogFile.close()
    overflow = [w for w in caught if "overflow" in str(w.message)]
    return report, launches, len(overflow)


def same_as_library(what, results, lib, markers):
    """The CLI's per-utterance results (sentence marks removed) against the
    library's `DecodeResult`s: words and word-end frames equal, total
    score bit for bit. Returns the number of utterances held."""
    for i, (ur, r) in enumerate(zip(results, lib)):
        want = [(h.word - 1, h.end_frame) for h in r.word_hyps if h.word not in markers]
        got = [(w.index, w.end_time) for w in ur.words]
        if got != want:
            raise RuntimeError(f"[{what}] utterance {i}: words or word-end frames differ "
                               f"from the library's")
        if ur.total_score != r.score:
            raise RuntimeError(f"[{what}] utterance {i}: score {ur.total_score!r} against the "
                               f"library's {r.score!r}")
    if len(results) != len(lib):
        raise RuntimeError(f"[{what}] {len(results)} results for {len(lib)} utterances")
    return len(results)


def verbose_summary(path):
    """(word accuracy line, RT factor line) of a verbose output file."""
    acc = rt = ""
    with open(path) as fd:
        for line in fd:
            if line.startswith("Word accuracy"):
                acc = line.strip()
            elif line.startswith("Real-time (RT) factor"):
                rt = line.strip()
    return acc, rt


def phase_cli_2k(card, dev, lib, phase_done):
    """[cli 2k]: three CLI calls on the 2k task (see the module docstring).
    `lib` holds the library's results: the first four seed-11 utterances
    of the main path and the seed-12 sentence. Returns the kernels line's
    CLI fields."""
    import subprocess
    import tempfile

    import numpy as np

    from juicer_tpu_torch.am.models import AcousticModelSet
    from juicer_tpu_torch.decoder.network import DecoderNetwork
    from juicer_tpu_torch.fst import algos, read_fsm, read_symbols
    from juicer_tpu_torch.harness import wsj_task

    cache = wsj_task.task_dir("2k")
    p = wsj_task.WSJ_POINT
    net = lib.pop("clg")  # [toolchain 2k]'s CLG, equal to clg.npz bit for bit
    models = AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
    utts = lib["utts"] + [lib["sent"]]
    names = [f"u{i}" for i in range(len(lib["utts"]))] + ["sent"]
    point = ["-mainBeam", str(p["beam"]), "-phoneEndBeam", str(p["end_beam"]),
             "-wordEmitBeam", str(p["end_beam"]), "-maxHyps", str(p["maxhyps"]),
             "-maxInsts", str(p["K"]), "-expandBudget", str(p["E"])]
    with tempfile.TemporaryDirectory() as td:
        base, _ = write_cli_task(td, cache, net, models, utts, names)
        del net

        # (a) one utterance a launch, xmlf, the binary caches written
        report, launches, n_ov = run_cli(
            base + point + ["-batchSize", "1", "-outputFormat", "xmlf", "-writeBinaryFiles",
                            "-outputFName", os.path.join(td, "a.mlf")])
        n = len(utts)
        if report.route != "route: frame_step kernel" or launches != (n, n) or n_ov:
            raise RuntimeError(f"[cli 2k] (a): route {report.route!r}, launches {launches}, "
                               f"overflow warnings {n_ov}")
        same_as_library("cli 2k (a)", report.results, lib["results"] + [lib["sent_result"]],
                        set())
        sent_a = report.results[-1]
        sent_words = [w.index + 1 for w in sent_a.words]
        print(f"[cli 2k] (a) -batchSize 1 -outputFormat xmlf -writeBinaryFiles: {n} "
              f"utterances, {report.route}; launches gmm_logsumexp {launches[0]}, frame_step "
              f"{launches[1]} (one each an utterance); words, word-end frames and scores "
              f"equal the library's; seconds: "
              + ", ".join(f"{k} {v:.3f}" for k, v in report.stages.items()), flush=True)
        launches_a = launches

        # (b) lattice and model-level output of the sentence, from the caches
        with open(os.path.join(td, "sent.lst"), "w") as fd:
            fd.write(f"sent={os.path.join(td, 'sent.htk')}\n")
        argv_b = [a if a != os.path.join(td, "in.lst") else os.path.join(td, "sent.lst")
                  for a in base]
        lat_dir = os.path.join(td, "lat")
        report, launches_b, _ = run_cli(
            argv_b + point + ["-latticeDir", lat_dir, "-modelLevelOutput", "-outputFormat",
                              "trans", "-outputFName", os.path.join(td, "b.trn")])
        why = "gen_lattice: the kernel writes no lattice records"
        if report.route != f"route: plain frame loop ({why})" or launches_b != (1, 0):
            raise RuntimeError(f"[cli 2k] (b): route {report.route!r}, launches {launches_b}")
        if "fsm parse" in report.stages or not os.path.exists(
                os.path.join(td, "net.fsm.npz")):
            raise RuntimeError("[cli 2k] (b) did not read the network's binary cache")
        lattice = read_fsm(os.path.join(lat_dir, "sent.lat.fsm"))
        _, _, best = algos.shortest_path(lattice)
        if best != sent_words:
            raise RuntimeError("[cli 2k] (b): the lattice's best path differs from (a)'s words")
        n_models = len(report.results[0].words)
        print(f"[cli 2k] (b) -latticeDir -modelLevelOutput, the sentence from (a)'s binary "
              f"caches ({', '.join(f'{k} {v:.3f}s' for k, v in report.stages.items())}): "
              f"{report.route}; launches gmm_logsumexp {launches_b[0]}, frame_step "
              f"{launches_b[1]}; lattice {lattice.num_states} states / {lattice.num_arcs} arcs, "
              f"best path = (a)'s {len(sent_words)} words; {n_models} models output",
              flush=True)

        # (c) -loop in a process of its own, the sentence's frames on stdin
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "juicer_tpu_torch.cli.juicer", *base, *point, "-loop",
             "-loopChunk", "100"],
            input=np.ascontiguousarray(utts[-1][1], dtype="<f4").tobytes(),
            capture_output=True, cwd=ROOT, timeout=600)
        t_loop = time.perf_counter() - t0
        if out.returncode != 0:
            raise RuntimeError(f"[cli 2k] (c) exited {out.returncode}: "
                               f"{out.stderr.decode()[-2000:]}")
        lines = out.stdout.decode().splitlines()
        words = [ln.split(": ", 1)[1].split(" (frame")[0] for ln in lines
                 if ln.startswith("partial: ")]
        final = lines[-1].split(": ", 1)[1].split() if lines and lines[-1].startswith(
            "final:") else None
        out_syms = read_symbols(os.path.join(td, "out.syms"))
        want = [out_syms[w] for w in sent_words]
        if final != want or words != want[:len(words)]:
            raise RuntimeError(f"[cli 2k] (c): final {final} and partials {words} against "
                               f"(a)'s {want}")
        if "route: frame_step kernel" not in out.stderr.decode():
            raise RuntimeError("[cli 2k] (c) did not stream through the frame-step kernel")
        print(f"[cli 2k] (c) -loop -loopChunk 100 as a subprocess ({t_loop:.1f}s, process "
              f"start and set-up included): {len(words)} partial words, each a prefix of "
              f"(a)'s {len(want)}, final equal to (a)'s words; route: frame_step kernel",
              flush=True)
        phase_done("cli 2k")
        launches_d = phase_cli_ref_2k(card, argv_b + point, td, sent_a, lib, phase_done)
        phase_cli_loop_audio_2k(card, base + point, out_syms, lib["loop"], phase_done)
        tool = phase_toolchain_cli_2k(card, td, base, point, utts, lib["host_builds"],
                                      phase_done)
    return {"gmm_logsumexp": {"launches_cli_2k": launches_a[0],
                              "launches_cli_2k_lattice": launches_b[0],
                              "launches_cli_ref_2k": launches_d[0],
                              "launches_stream_audio_2k": lib["loop"]["launches"][0],
                              "launches_toolchain_cli_2k": tool["launches"][0]},
            "frame_step": {"launches_cli_2k": launches_a[1],
                           "launches_cli_2k_lattice": launches_b[1],
                           "launches_cli_ref_2k": launches_d[1],
                           "launches_stream_audio_2k": lib["loop"]["launches"][1],
                           "launches_toolchain_cli_2k": tool["launches"][1]}}


def f32_spacings(a, b, size):
    """|a - b| in float32 spacings at |size|."""
    import numpy as np

    return abs(a - b) / float(np.spacing(np.float32(abs(size))))


def phase_cli_ref_2k(card, argv, td, sent_a, lib, phase_done):
    """[cli ref 2k] (d): -refCore on the seed-12 sentence, from (a)'s binary
    caches: the oracle token passing on the host over one host copy of the
    sentence's GMM kernel scores. Its words are the transcript and (a)'s;
    its scores lie within 16 float32 spacings of (a)'s (the frame-step
    route sums in float32, the oracle in float64). Returns the launches."""
    report, launches, n_ov = run_cli(argv + ["-refCore", "-outputFormat", "xmlf",
                                             "-outputFName", os.path.join(td, "d.mlf")])
    route = "route: oracle token passing on the host (-refCore; GMM scores on cuda"
    if not report.route.startswith(route) or launches != (1, 0) or n_ov:
        raise RuntimeError(f"[cli ref 2k]: route {report.route!r}, launches {launches}, "
                           f"overflow warnings {n_ov}")
    ur = report.results[0]
    got = [(w.index + 1, w.end_time) for w in ur.words]
    if got != [(w.index + 1, w.end_time) for w in sent_a.words]:
        raise RuntimeError(f"[cli ref 2k]: the oracle's words or word-end frames {got} differ "
                           f"from the kernel route's")
    if [i for i, _ in got if i not in lib["markers"]] != lib["transcript"]:
        raise RuntimeError("[cli ref 2k]: the oracle's words are not the transcript")
    gaps = [f32_spacings(ur.total_score, sent_a.total_score, sent_a.total_score),
            f32_spacings(ur.total_acoustic, sent_a.total_acoustic, sent_a.total_acoustic),
            f32_spacings(ur.total_lm, sent_a.total_lm, sent_a.total_acoustic)]
    if not max(gaps) <= 16:
        raise RuntimeError(f"[cli ref 2k]: scores {gaps} float32 spacings from the kernel "
                           f"route's")
    st = report.stages
    print(f"[cli ref 2k] (d) -refCore on the {ur.n_frames}-frame sentence: {report.route}; "
          f"launches gmm_logsumexp {launches[0]}, frame_step {launches[1]}; {len(got)} words "
          f"and word-end frames equal (a)'s (the kernel route) and the transcript; score "
          f"{ur.total_score!r} against {sent_a.total_score!r}, acoustic {ur.total_acoustic!r} "
          f"against {sent_a.total_acoustic!r}, lm {ur.total_lm!r} against "
          f"{sent_a.total_lm!r}: {', '.join(f'{g:.2f}' for g in gaps)} float32 spacings "
          f"(bound 16); the oracle's decode {st['decode']:.3f}s ({ur.n_frames / st['decode']:.1f} "
          f"frames/s on the host); seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items()) + f" | {card}", flush=True)
    phase_done("cli ref 2k")
    return launches


def phase_cli_loop_audio_2k(card, argv, out_syms, lib, phase_done):
    """[cli loop audio 2k] (e): -loop -audioDevice - as a subprocess, the
    S16LE PCM of `lib` on stdin: the streaming front end and the stream
    decoder on the card. Its partial and final words equal the library's
    (`StreamingDecoder` fed the port's `StreamingFrontend` on the same PCM
    on the card, `stream_audio_library`)."""
    import subprocess

    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "juicer_tpu_torch.cli.juicer", *argv, "-loop", "-loopChunk",
         str(STREAM_CHUNK), "-audioDevice", "-"],
        input=lib["pcm"].tobytes(), capture_output=True, cwd=ROOT, timeout=600)
    t_loop = time.perf_counter() - t0
    err = out.stderr.decode()
    if out.returncode != 0:
        raise RuntimeError(f"[cli loop audio 2k] exited {out.returncode}: {err[-2000:]}")
    lines = out.stdout.decode().splitlines()
    partial = [ln.split(": ", 1)[1].split(" (frame")[0] for ln in lines
               if ln.startswith("partial: ")]
    final = (lines[-1].split(": ", 1)[1].split() if lines and lines[-1].startswith("final:")
             else None)
    want = [out_syms[w] for w in lib["final"]]
    if final != want or partial != [out_syms[w] for w in lib["partial"]]:
        raise RuntimeError(f"[cli loop audio 2k]: final {final} and partials {partial} "
                           f"against the library's {want}")
    front = "front end: MFCC of PCM, streamed on cuda"
    if "route: frame_step kernel" not in err or front not in err:
        raise RuntimeError("[cli loop audio 2k] did not stream through the card's front end "
                           "and the frame-step kernel")
    print(f"[cli loop audio 2k] (e) -loop -audioDevice - -loopChunk {STREAM_CHUNK} as a "
          f"subprocess, {len(lib['pcm'])} samples of PCM on stdin ({t_loop:.1f}s, process "
          f"start and set-up included): route: frame_step kernel, {front}; {len(partial)} "
          f"partial and {len(final)} final words equal the library's StreamingDecoder fed "
          f"StreamingFrontend on the card (overflow {lib['overflow']}) | {card}", flush=True)
    phase_done("cli loop audio 2k")


def stream_audio_library(art, task, scorer, dev):
    """The library side of [cli loop audio 2k]: LOOP_FRAMES frames of
    `wsj_task.sample_audio` (seed LOOP_SEED) as S16LE PCM through
    `capture_features` (the streaming front end on the card) in chunks of
    STREAM_CHUNK frames' samples, each chunk scored by the GMM kernel and
    fed to a `StreamingDecoder` over a decoder of the CLI's configuration
    at `WSJ_POINT`. Returns the PCM, the partial and final words, the
    chunks and the launches of both kernels."""
    import io

    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.decoder.core import TorchDecoder, TorchDecoderConfig
    from juicer_tpu_torch.decoder.stream import StreamingDecoder
    from juicer_tpu_torch.harness import wsj_task
    from juicer_tpu_torch.harness.capture import PcmSource, capture_features
    from juicer_tpu_torch.ops import gmm_cuda

    p = wsj_task.WSJ_POINT
    pcm = wsj_task.sample_audio(task.cache, task.models, [LOOP_FRAMES], LOOP_SEED)[0][1]
    dec = TorchDecoder(art, TorchDecoderConfig(
        max_insts=p["K"], expand_budget=p["E"], emit_prune_win=p["beam"],
        phone_end_prune_win=p["end_beam"], word_prune_win=p["end_beam"],
        max_emit_hyps=p["maxhyps"]), device=dev)
    stream = StreamingDecoder(dec)
    n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    partial, n_chunks, n_frames = [], 0, 0
    src = PcmSource(stream=io.BytesIO(pcm.tobytes()))
    for feats in capture_features(src, chunk_samples=STREAM_CHUNK * 160, device=dev):
        if feats.device != dev:
            raise RuntimeError("[2k stream audio] the front end left the card")
        partial += stream.feed(scorer(feats))
        n_chunks += 1
        n_frames += feats.shape[0]
    fin = stream.finish()
    launches = (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])
    if n_frames != LOOP_FRAMES or launches != (n_chunks, n_chunks):
        raise RuntimeError(f"[2k stream audio] {n_frames} frames in {n_chunks} chunks, "
                           f"launches {launches}")
    print(f"[2k stream audio] {LOOP_FRAMES} frames of audio (seed {LOOP_SEED}) through the "
          f"streaming front end on the card in {n_chunks} chunks: launches gmm_logsumexp "
          f"{launches[0]}, frame_step {launches[1]}; {len(partial)} partial words, "
          f"{len(fin.words)} final; overflow {fin.overflow}, empty {fin.empty}", flush=True)
    return dict(pcm=pcm, final=fin.words, partial=[h.word for h in partial],
                launches=launches, overflow=fin.overflow)


def phase_cli_20k(card, dev, lib, phase_done):
    """[cli 20k]: the slice's full-width path, the CLI at the reference
    bench's 20k task (see the module docstring). `lib` holds the [20k]
    phase's utterances and B=16 results and its entry point's frames/s.
    Returns the kernels line's CLI fields."""
    import tempfile

    import torch

    from juicer_tpu_torch.am.models import AcousticModelSet
    from juicer_tpu_torch.decoder.network import DecoderNetwork
    from juicer_tpu_torch.harness import wsj_task
    from juicer_tpu_torch.ops.gmm import make_gmm_scorer

    cache = wsj_task.task_dir("20k")
    p = wsj_task.WSJ_POINT
    B = p["batch"]
    utts, results = lib["utts"], lib["results"]
    net = DecoderNetwork.load_npz(os.path.join(cache, "clg.npz"))
    models = AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
    tiled = [utts[i % len(utts)] for i in range(B)]
    names = [f"u{i:02d}" for i in range(B)]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        base, t_net = write_cli_task(td, cache, net, models, tiled, names)
        t_write = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(td, "net.fsm"))
        t0 = time.perf_counter()
        back = DecoderNetwork.from_files(*(os.path.join(td, n)
                                           for n in ("net.fsm", "in.syms", "out.syms")))
        t_back = time.perf_counter() - t0
        same, differ = check_network_read_back("cli 20k", back, net)
        check_models_read_back("cli 20k", AcousticModelSet.from_mmf(
            os.path.join(td, "models.mmf")), models)
        print(f"[cli 20k] files written in {t_write:.1f}s (the network's {net.n_arcs} arcs "
              f"as {size} bytes of text in {t_net:.1f}s); read back in {t_back:.1f}s: every "
              f"array of clg.npz equal, {', '.join(same)} equal"
              + (f", {', '.join(differ)} differ" if differ else "")
              + "; the MMF's flat_params and topology equal models.npz's bit for bit",
              flush=True)
        del back, net
        gc.collect()
        phase_done("cli 20k files")

        out = os.path.join(td, "out.txt")
        argv = base + ["-refFName", os.path.join(td, "refs.txt"), "-removeSentMarks",
                       "-batchSize", str(B), "-mainBeam", str(p["beam"]),
                       "-phoneEndBeam", str(p["end_beam"]), "-wordEmitBeam",
                       str(p["end_beam"]), "-maxHyps", str(p["maxhyps"]),
                       "-maxInsts", str(p["K"]), "-expandBudget", str(p["E"]),
                       "-outputFormat", "verbose", "-outputFName", out,
                       "-logFName", os.path.join(td, "juicer.log")]
        report, launches, n_ov = run_cli(argv)
        acc, rt = verbose_summary(out)
        with open(os.path.join(td, "juicer.log")) as fd:
            logged_route = report.route in fd.read()
        phase_done("cli 20k run")
        if report.route != "route: frame_step kernel" or not logged_route:
            raise RuntimeError(f"[cli 20k] route {report.route!r} (in the log: {logged_route})")
        if not acc.startswith("Word accuracy = 100.00%") or n_ov:
            raise RuntimeError(f"[cli 20k] not certified: {acc!r}, {n_ov} overflow warnings")
        if launches != (B, 1):
            raise RuntimeError(f"[cli 20k] launches gmm_logsumexp, frame_step {launches}; "
                               f"expected {B} and 1")
        n_held = same_as_library("cli 20k", report.results, results, lib["markers"])
        # the GMM kernel's bits do not depend on the call: each utterance alone
        # against its rows of the whole wave
        scorer = make_gmm_scorer(models.flat_params(), device="cuda")
        feats, lengths, Tmax = tile_features(utts, B, dev)
        wave = scorer(feats.reshape(B * Tmax, -1)).view(B, Tmax, -1)
        bits = all(torch.equal(scorer(torch.as_tensor(f, device=dev)), wave[i, :len(f)])
                   for i, (_, f) in enumerate(utts))
        if not bits:
            raise RuntimeError("[cli 20k] gmm_logsumexp gives other bits for a frame scored "
                               "alone than in the wave")
        st = report.stages
        frames = sum(len(f) for _, f in tiled)
        fps_pad = B * Tmax / st["decode"]
        print(f"[cli 20k] {report.route}; certified: {acc}; overflow 0/{B}; launches "
              f"gmm_logsumexp {launches[0]} (one an utterance), frame_step {launches[1]} (one "
              f"a batch); words, word-end frames and scores of all {n_held} utterances equal the "
              f"[20k] BatchDecoder's bit for bit; gmm_logsumexp scores each utterance alone "
              f"with the bits of its rows in the whole wave", flush=True)
        print(f"[cli 20k] seconds: text write {t_write:.3f}, "
              + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
              + f"; verbose output {rt!r} (decode {st['decode']:.4f}s over "
              f"{report.speech_time:.2f}s of speech: RT factor {st['decode'] / report.speech_time:.5f}) "
              f"| {card}", flush=True)
        print(f"[cli 20k] decode: {B} x {Tmax} padded frames ({frames} true) in "
              f"{st['decode']:.4f}s = {fps_pad:.1f} frames/s ({frames / st['decode']:.1f} true "
              f"frames/s; one batch, its first call: the fused scan's set-up and 16 GMM launches "
              f"included) beside the library entry point's {lib['entry_fps']:.1f} frames/s "
              f"(a warm BatchDecoder wave of this call) | {card}", flush=True)
        audio = phase_cli_audio_20k(card, base, td, lib["audio"], lib["markers"], phase_done)
    return {"gmm_logsumexp": {"launches_cli_20k": launches[0],
                              "launches_cli_audio_20k": audio["launches"][0]},
            "frame_step": {"launches_cli_20k": launches[1], "cli_20k_fps": fps_pad,
                           "cli_20k_stages": {"text write": t_write, **st},
                           "launches_cli_audio_20k": audio["launches"][1],
                           "cli_audio_20k_overflow": audio["overflow"],
                           "cli_audio_20k_stages": audio["stages"]}}


def phase_cli_otf(card, dev, lib, phase_done):
    """[cli otf]: the 20k on-the-fly pair through -gramFsmFName (see the
    module docstring). `lib` holds [otf]'s utterances, main-path results
    and tuned budgets. Returns the kernels line's CLI fields."""
    import tempfile

    import numpy as np

    from juicer_tpu_torch.am.models import AcousticModelSet
    from juicer_tpu_torch.compile import arpa_grammar
    from juicer_tpu_torch.decoder.network import DecoderNetwork
    from juicer_tpu_torch.decoder.otf import GNetwork
    from juicer_tpu_torch.fst import read_fsm
    from juicer_tpu_torch.harness import wsj_task

    cache = wsj_task.task_dir("20k")
    p = wsj_task.OTF_POINT
    tuned = lib["tuned"]
    if tuned.final_budget != 1024:
        raise RuntimeError(f"[cli otf] the tuner moved F to {tuned.final_budget}; the CLI "
                           f"has no flag for it (its F is 1024)")
    B = len(lib["utts"])
    cl = lib.pop("cl")  # [toolchain 20k]'s CL, equal to cl.npz bit for bit
    want = DecoderNetwork.load_npz(os.path.join(cache, "cl.npz"))
    models = AcousticModelSet.load_npz(os.path.join(cache, "models.npz"))
    vocab = wsj_task.task_lexicon(cache).vocab
    G = arpa_grammar(vocab, os.path.join(cache, "lm.arpa"))
    g_want = GNetwork(G)
    names = [f"u{i}" for i in range(B)]
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        base, _ = write_cli_task(td, cache, cl, models, lib["utts"], names)
        write_fst_text(G, os.path.join(td, "g.fsm"))
        t_write = time.perf_counter() - t0
        back = DecoderNetwork.from_files(*(os.path.join(td, n)
                                           for n in ("net.fsm", "in.syms", "out.syms")),
                                         remove_aux="input")
        same, differ = check_network_read_back("cli otf", back, want)
        g_got = GNetwork(read_fsm(os.path.join(td, "g.fsm")))
        for k in ("arc_il", "arc_dst", "arc_w", "row_ptr", "bo_dst", "bo_w", "final_w",
                  "final_reach", "arc_key"):
            if not np.array_equal(getattr(g_got, k), getattr(g_want, k)):
                raise RuntimeError(f"[cli otf] G read from text differs in {k}")
        if (g_got.n_states, g_got.init_state, g_got.max_backoff) != (
                g_want.n_states, g_want.init_state, g_want.max_backoff):
            raise RuntimeError("[cli otf] G read from text differs in its scalars")
        out = os.path.join(td, "out.txt")
        argv = base + ["-gramFsmFName", os.path.join(td, "g.fsm"), "-refFName",
                       os.path.join(td, "refs.txt"), "-removeSentMarks", "-batchSize", str(B),
                       "-mainBeam", str(p["beam"]), "-phoneEndBeam", str(p["end_beam"]),
                       "-wordEmitBeam", str(p["end_beam"]), "-maxHyps", str(p["maxhyps"]),
                       "-maxInsts", str(tuned.max_insts), "-expandBudget",
                       str(tuned.expand_budget), "-outputFormat", "verbose",
                       "-outputFName", out]
        report, launches, n_ov = run_cli(argv)
        acc, rt = verbose_summary(out)
    why = "on-the-fly composition: the kernel searches a static network"
    if report.route != f"route: plain frame loop ({why})":
        raise RuntimeError(f"[cli otf] route {report.route!r}")
    if not acc.startswith("Word accuracy = 100.00%") or n_ov:
        raise RuntimeError(f"[cli otf] not certified: {acc!r}, {n_ov} overflow warnings")
    if launches != (B, 0):
        raise RuntimeError(f"[cli otf] launches gmm_logsumexp, frame_step {launches}; "
                           f"expected {B} and 0")
    n_held = same_as_library("cli otf", report.results, lib["results"], lib["markers"])
    st = report.stages
    print(f"[cli otf] CL ({cl.n_arcs} arcs, [toolchain 20k]'s) and G ({G.num_arcs} arcs) "
          f"written as text in {t_write:.2f}s and read back equal to cl.npz and to the "
          f"in-memory G (every "
          f"array; {', '.join(same)} equal"
          + (f", {', '.join(differ)} differ" if differ else "") + f"); {report.route}; "
          f"-maxInsts {tuned.max_insts} -expandBudget {tuned.expand_budget} (the tuned "
          f"budgets of [otf]); certified: {acc}; launches gmm_logsumexp {launches[0]}, "
          f"frame_step {launches[1]}; all {n_held} utterances equal [otf]'s main path (words, "
          f"word-end frames, scores); seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items()) + f"; {rt} | {card}", flush=True)
    phase_done("cli otf")
    return ({"gmm_logsumexp": {"launches_cli_otf": launches[0]},
             "frame_step": {"launches_cli_otf": launches[1]}}, G)


def phase_toolchain_20k(card, phase_done):
    """[toolchain 20k]: the 20k CL rebuilt by the port's offline toolchain
    from `phones.lst` and `lex.dict` (`wsj_task.build_task`'s CL half:
    `LexGen`, `minimize(determinize(arcsort(L)))`, the monophone `CDGen`,
    `compose(C, closure(arcsort(L)))`) and held to cl.npz bit for bit.
    Returns the network, which [cli otf] writes as its CL text."""
    from juicer_tpu_torch.harness import wsj_task

    t0 = time.perf_counter()
    out = wsj_task.build_task("20k", networks=("cl",), verbose=False)
    cl = out["cl"]
    print(f"[toolchain 20k] CL = C o closure(min(det(L))) rebuilt on the host in "
          f"{time.perf_counter() - t0:.2f}s: {cl.n_states} states, {cl.n_arcs} arcs, equal to "
          f"cl.npz bit for bit (every array; {', '.join(wsj_task.NETWORK_SCALARS)}); peak host "
          f"RSS {wsj_task.peak_rss_bytes() / 2**30:.2f} GiB | {card}", flush=True)
    phase_done("toolchain 20k")
    return cl


def phase_toolchain_2k(card, host_builds, phase_done):
    """[toolchain 2k]: the 2k CLG rebuilt by the port's offline toolchain
    from `phones.lst`, `lex.dict` and `lm.arpa` (`wsj_task.build_task`'s
    CLG half: `GramGen(NGRAM)`, `LexGen`, the monophone `CDGen`,
    `build_clg(verbose=True)`, which prints each stage's states, arcs and
    seconds) in the child process `start_host_builds` started, which holds
    it to clg.npz bit for bit; its lines are printed here, and the network
    it wrote is held to clg.npz again in this process. Returns the
    network, which [cli 2k] writes as its CLG text."""
    from juicer_tpu_torch.decoder.network import DecoderNetwork
    from juicer_tpu_torch.harness import wsj_task

    tools, build, _ = host_builds
    t0 = time.perf_counter()
    rc, out, seconds = build.result()
    waited = time.perf_counter() - t0
    print(out.rstrip(), flush=True)
    if rc != 0:
        raise RuntimeError(f"[toolchain 2k] wsj_task --build 2k exited {rc}")
    net = DecoderNetwork.load_npz(os.path.join(tools, "clg.npz"))
    wsj_task.require_same_network("[toolchain 2k] clg", net, DecoderNetwork.load_npz(
        os.path.join(wsj_task.task_dir("2k"), "clg.npz")))
    print(f"[toolchain 2k] CLG rebuilt on the host in {seconds:.1f}s, in a child process "
          f"started with the smoke (waited for {waited:.1f}s here): {net.n_states} states, "
          f"{net.n_arcs} arcs, equal to clg.npz bit for bit (every array; "
          f"{', '.join(wsj_task.NETWORK_SCALARS)}) there and here | {card}", flush=True)
    phase_done("toolchain 2k")
    return net


# the JAX tools' counts on the 2k files (-gramType ngram; -silMonophone sil
# -pauseMonophone sp -outputAuxPhones; -cdType monophone): the CLI route's
# CLG differs from clg.npz's 181,003 / 1,617,510 (the monophone C carries
# its aux self-loops twice, and the text between the tools has three
# decimals)
TOOLCHAIN_CLI_2K = {"g.fsm": (2004, 123026), "l.fsm": (11195, 13195), "c.fsm": (1, 51),
                    "final.fsm": (178593, 1605301)}


def phase_toolchain_cli_2k(card, td, base, point, utts, host_builds, phase_done):
    """[toolchain cli 2k]: the users' entry points end to end:
    `jtpu-gramgen-torch`, `jtpu-lexgen-torch`, `jtpu-cdgen-torch` and
    `jtpu-build-wfst-torch` on the 2k files (each `python -m` in a child
    process, in turn, started with the smoke by `start_host_builds`, into
    its directory), then `jtpu-juicer-torch` on final.fsm and
    final.{in,out}syms at `WSJ_POINT`, one utterance a launch, in [cli
    2k]'s directory td (its MMF, lexicon, features, input list and
    references). Certified: overflow 0, dead 0, the words of every
    utterance equal its transcript, route `frame_step kernel`, one launch
    of each kernel an utterance. Then `jtpu-genwfstseqs-torch` on
    final.fsm, `jtpu-hmmgen-torch` and `jtpu-untie-torch` on the MMF (a
    tied list of four logical names), their outputs read back. Returns the
    decode's launches."""
    import contextlib
    import io
    import math

    import numpy as np

    from juicer_tpu_torch.am.models import AcousticModelSet
    from juicer_tpu_torch.cli import genwfstseqs, hmmgen, untie
    from juicer_tpu_torch.fst import read_fsm, read_symbols

    tools, _, built = host_builds

    def j(name):
        return os.path.join(td, name)

    def in_tools(name):
        return os.path.join(tools, name)

    def outs(prefix):
        return ["-fsmFName", j(f"{prefix}.fsm"), "-inSymsFName", j(f"{prefix}.insyms"),
                "-outSymsFName", j(f"{prefix}.outsyms")]

    t0 = time.perf_counter()
    done = built.result()
    waited = time.perf_counter() - t0
    tool_s = {}
    for name, rc, said, seconds in done:
        tool_s[name] = seconds
        if rc != 0:
            raise RuntimeError(f"[toolchain cli 2k] jtpu-{name}-torch exited {rc}: "
                               f"{said[-2000:]}")
        print(f"[toolchain cli 2k] jtpu-{name}-torch ({seconds:.1f}s, a child process): "
              f"{said.strip()}", flush=True)
    print(f"[toolchain cli 2k] the tools ran beside the earlier phases; waited for "
          f"{waited:.1f}s here", flush=True)
    counts = {}
    for f, want in TOOLCHAIN_CLI_2K.items():
        m = read_fsm(in_tools(f))
        counts[f] = (m.num_states, m.num_arcs)
        if counts[f] != want:
            raise RuntimeError(f"[toolchain cli 2k] {f}: {counts[f]} states and arcs, the JAX "
                               f"tools' {want}")
        del m
    gc.collect()

    # the decode, one utterance a launch
    final = ["-fsmFName", in_tools("final.fsm"), "-inSymsFName", in_tools("final.insyms"),
             "-outSymsFName", in_tools("final.outsyms")]
    argv = [a for a in base]
    for flag, value in zip(final[::2], final[1::2]):
        argv[argv.index(flag) + 1] = value
    out = j("tool_out.txt")
    report, launches, n_ov = run_cli(
        argv + point + ["-batchSize", "1", "-refFName", j("refs.txt"), "-removeSentMarks",
                        "-outputFormat", "verbose", "-outputFName", out])
    acc, rt = verbose_summary(out)
    out_syms = read_symbols(in_tools("final.outsyms"))
    dead = sum(1 for ur in report.results if not ur.words or not math.isfinite(ur.total_score))
    wrong = [i for i, (ur, (words, _)) in enumerate(zip(report.results, utts))
             if [out_syms[w.index + 1] for w in ur.words] != [f"w{w}" for w in words]]
    n = len(utts)
    if n_ov or dead or wrong or len(report.results) != n or not acc.startswith(
            "Word accuracy = 100.00%"):
        raise RuntimeError(f"[toolchain cli 2k] not certified: overflow {n_ov}/{n}, dead "
                           f"{dead}/{n}, utterances off their transcript {wrong}, {acc!r}")
    if report.route != "route: frame_step kernel" or launches != (n, n):
        raise RuntimeError(f"[toolchain cli 2k] route {report.route!r}, launches gmm_logsumexp, "
                           f"frame_step {launches}; expected {n} and {n}")
    st = report.stages
    print(f"[toolchain cli 2k] jtpu-juicer-torch on final.fsm ({counts['final.fsm'][0]} states, "
          f"{counts['final.fsm'][1]} arcs: the CLI route's CLG, not clg.npz's) at WSJ_POINT, "
          f"-batchSize 1: {report.route}; certified: {acc}; overflow {n_ov}/{n}, dead {dead}/{n}, "
          f"every utterance's words equal its transcript; launches gmm_logsumexp {launches[0]}, "
          f"frame_step {launches[1]} (one each an utterance); seconds: tools "
          + ", ".join(f"{k} {v:.1f}" for k, v in tool_s.items()) + "; juicer "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items()) + f"; {rt} | {card}", flush=True)

    # genwfstseqs on the network, hmmgen and untie on the models
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = genwfstseqs.main([*final, "-nSeqs", "5", "-seed", "0"])
    in_syms = set(read_symbols(in_tools("final.insyms")))
    seqs = said.getvalue().splitlines()
    if rc != 0 or len(seqs) != 5 or not all(
            set(ln.split(" : ")[0].split()) <= in_syms for ln in seqs):
        raise RuntimeError(f"[toolchain cli 2k] jtpu-genwfstseqs-torch exited {rc}: {seqs}")
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = hmmgen.main(["-htkModelsFName", j("models.mmf"), *outs("h")])
    models = AcousticModelSet.from_mmf(j("models.mmf"))
    h = read_fsm(j("h.fsm"))
    n_h = 2 + sum(models.get_num_states(i) for i in range(len(models.hmm_names)))
    if rc != 0 or h.num_states != n_h or len(read_symbols(j("h.outsyms"))) != len(
            models.hmm_names) + 1:
        raise RuntimeError(f"[toolchain cli 2k] jtpu-hmmgen-torch exited {rc}: {h.num_states} "
                           f"states, expected {n_h}")
    names = models.hmm_names
    tied = {f"x-{names[0]}+{names[1]}": names[0], f"{names[2]}-{names[1]}": names[1],
            "Zz": names[2], names[3]: names[3]}
    with open(j("tied.lst"), "w") as fd:
        fd.write("".join(f"{k} {v}\n" if k != v else f"{k}\n" for k, v in tied.items()))
    with contextlib.redirect_stdout(io.StringIO()) as said:
        rc = untie.main(["-htkModelsFName", j("models.mmf"), "-tiedListFName", j("tied.lst"),
                         "-outModelsFName", j("untied.mmf"), "-outListFName", j("untied.lst")])
    if rc != 0:
        raise RuntimeError(f"[toolchain cli 2k] jtpu-untie-torch exited {rc}")
    untied = AcousticModelSet.from_mmf(j("untied.mmf"))
    with open(j("untied.lst")) as fd:
        listed = fd.read().split()
    logical = sorted(tied, key=str.encode)
    # the MMF writer's "%e" keeps seven significant digits
    same = all(np.allclose(untied.gmm_means[int(g)], models.gmm_means[int(k)], rtol=1e-6,
                           atol=0.0)
               for name in logical
               for g, k in zip(untied.hmm_gmm_inds[untied.get_hmm_index(name)],
                               models.hmm_gmm_inds[models.get_hmm_index(tied[name])]))
    if untied.hmm_names != logical or listed != logical or not same:
        raise RuntimeError(f"[toolchain cli 2k] jtpu-untie-torch: {untied.hmm_names}, list "
                           f"{listed}, means equal to the physical models' {same}")
    print(f"[toolchain cli 2k] jtpu-genwfstseqs-torch -nSeqs 5: 5 sequences over "
          f"final.insyms; jtpu-hmmgen-torch: H of {h.num_states} states, {h.num_arcs} arcs "
          f"({len(names)} models); jtpu-untie-torch: {len(names)} physical -> {len(logical)} "
          f"logical models, read back with each logical model's means its physical model's "
          f"(within the writer's seven digits), the list sorted | {card}", flush=True)
    phase_done("toolchain cli 2k")
    return dict(launches=launches)


def phase_gramgen_20k(card, G, phase_done):
    """[gramgen 20k]: `jtpu-gramgen-torch -gramType ngram` (its `main`, in
    this process) on the 20k task's lex.dict and lm.arpa. Its G, read back
    from the AT&T text, equals the G that [otf] builds
    (`compile.arpa_grammar`) arc for arc: states, start, every arc's
    source, destination and labels in order, the final states; weights
    within 5e-4 (the writer's three decimals; finals six). Its output
    symbols are the vocabulary's words with a pronunciation."""
    import tempfile

    import numpy as np

    from juicer_tpu_torch.cli import gramgen
    from juicer_tpu_torch.fst import read_fsm, read_symbols
    from juicer_tpu_torch.harness import wsj_task

    cache = wsj_task.task_dir("20k")
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        rc = gramgen.main(["-lexFName", os.path.join(cache, "lex.dict"), "-sentStartWord", "<s>",
                           "-sentEndWord", "</s>", "-gramType", "ngram", "-lmFName",
                           os.path.join(cache, "lm.arpa"), "-fsmFName",
                           os.path.join(td, "g.fsm"), "-inSymsFName",
                           os.path.join(td, "g.insyms"), "-outSymsFName",
                           os.path.join(td, "g.outsyms")])
        t_gen = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(td, "g.fsm"))
        back = read_fsm(os.path.join(td, "g.fsm"))
        osyms = read_symbols(os.path.join(td, "g.outsyms"))
    if rc != 0:
        raise RuntimeError(f"[gramgen 20k] exited {rc}")
    if (back.num_states, back.start, back.num_arcs) != (G.num_states, G.start, G.num_arcs):
        raise RuntimeError(f"[gramgen 20k] {back.num_states} states, start {back.start}, "
                           f"{back.num_arcs} arcs against [otf]'s {G.num_states}, {G.start}, "
                           f"{G.num_arcs}")
    for k in ("arc_src", "arc_dst", "arc_ilabel", "arc_olabel"):
        if not np.array_equal(np.asarray(getattr(back, k)), np.asarray(getattr(G, k))):
            raise RuntimeError(f"[gramgen 20k] {k} differs from [otf]'s G")
    w_err = float(np.abs(np.asarray(back.arc_weight) - np.asarray(G.arc_weight)).max())
    if sorted(back.finals) != sorted(G.finals):
        raise RuntimeError("[gramgen 20k] the final states differ from [otf]'s G")
    f_err = max(abs(back.finals[q] - G.finals[q]) for q in G.finals)
    if not (w_err <= 5e-4 + 1e-9 and f_err <= 5e-7):
        raise RuntimeError(f"[gramgen 20k] weights {w_err}, finals {f_err} from [otf]'s G")
    words = sorted({w for w in G.osyms} - {"<eps>"}) if G.osyms is not None else []
    if sorted(set(osyms) - {"<eps>", None}) != words:
        raise RuntimeError("[gramgen 20k] the output symbols differ from the vocabulary's")
    print(f"[gramgen 20k] jtpu-gramgen-torch -gramType ngram: {back.num_states} states, "
          f"{back.num_arcs} arcs, {size} bytes of text in {t_gen:.2f}s (host); read back equal "
          f"to [otf]'s G arc for arc (labels and states exact; weights within {w_err:.2e} of the "
          f"three-decimal text, finals {f_err:.1e}); {len(words)} output words | {card}",
          flush=True)
    phase_done("gramgen 20k")


def write_wav(path, pcm, rate=16000):
    import wave

    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def mllr_texts(models, seed):
    """A two-class base-class file (class 1: the states of the models whose
    names start p0, p1 or p2; class 2: every other state) and an MLLRMEAN
    set of two transforms A = I + N(0, 0.02^2), b = N(0, 0.1^2), from a
    seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    D = models.vec_size
    base = ('~b "two"\n<MMFIDMASK> *\n<PARAMETERS> MIXBASE\n<NUMCLASSES> 2\n'
            "<CLASS> 1 {(p0*,p1*,p2*).state[2-4]}\n<CLASS> 2 {*.state[2-4]}\n")
    xf = ""
    for k in (1, 2):
        A = np.eye(D) + rng.normal(scale=0.02, size=(D, D))
        xf += (f"<LINXFORM> {k}\n<VECSIZE> {D}\n<OFFSET>\n<BIAS> {D}\n "
               + " ".join(repr(float(x)) for x in rng.normal(scale=0.1, size=D))
               + f"\n<BLOCKINFO> 1 {D}\n<BLOCK> 1\n<XFORM> {D} {D}\n "
               + "\n ".join(" ".join(repr(float(x)) for x in row) for row in A) + "\n")
    mllr = ('~a "spk"\n<ADAPTKIND> TREE\n<BASECLASS> ~b "two"\n<XFORMSET>\n'
            "<XFORMKIND> MLLRMEAN\n<NUMXFORMS> 2\n" + xf
            + "<XFORMWGTSET>\n<CLASSXFORM> 1 1\n<CLASSXFORM> 2 2\n")
    return base, mllr


def audio_library(task, dec, lengths, dev, card):
    """The library side of [cli audio 20k], on the [20k] decoder: audio of
    `lengths` frames (`wsj_task.sample_audio`, seed AUDIO_SEED), the batched
    front end on the card (held to `mfcc` of each utterance on the CPU
    within FRONT_ATOL), the means adapted by MLLR (`mllr_texts`) on the card
    (held to the CPU's within PARAM_TOL), scored by the GMM kernel one
    utterance at a time, edge-padded and decoded by `BatchDecoder`, as the
    CLI does. Returns what [cli audio 20k] is held to."""
    import tempfile

    import numpy as np
    import torch

    from juicer_tpu_torch.am.regtree import apply_mllr_means, parse_baseclass, parse_xformset
    from juicer_tpu_torch.decoder import fused_scan
    from juicer_tpu_torch.harness import frontend, wsj_task
    from juicer_tpu_torch.ops import gmm_cuda
    from juicer_tpu_torch.ops.gmm import make_gmm_scorer
    from juicer_tpu_torch.parallel.mesh import BatchDecoder

    models = task.models
    t0 = time.perf_counter()
    waves = [pcm for _, pcm in wsj_task.sample_audio(task.cache, models, lengths, AUDIO_SEED)]
    t_make = time.perf_counter() - t0
    base, mllr = mllr_texts(models, AUDIO_SEED)
    with tempfile.TemporaryDirectory() as td:
        for name, text in (("two.base", base), ("spk.mllr", mllr)):
            with open(os.path.join(td, name), "w") as fd:
                fd.write(text)
        bc = parse_baseclass(os.path.join(td, "two.base"))
        xset = parse_xformset(os.path.join(td, "spk.mllr"))
    signals = [w.astype(np.float64) for w in waves]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, got_lengths = frontend.mfcc_batch(signals, device=dev)
    torch.cuda.synchronize()
    t_front = time.perf_counter() - t0
    if got_lengths != list(lengths) or feats.device != dev:
        raise RuntimeError(f"[20k audio] front end lengths {got_lengths} for {list(lengths)}")
    front_err = max(float((feats[b, :n].cpu() - frontend.mfcc(x, device="cpu")).abs().max())
                    for b, (x, n) in enumerate(zip(signals, lengths)))
    if not front_err <= FRONT_ATOL:
        raise RuntimeError(f"[20k audio] batched front end on the card {front_err} from mfcc "
                           f"on the CPU")
    t0 = time.perf_counter()
    adapted = apply_mllr_means(models, xset, bc, device=dev)
    t_mllr = time.perf_counter() - t0
    on_cpu = apply_mllr_means(models, xset, bc, device="cpu")

    def rel(a, b):
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

    fc, fh = adapted.flat_params(np.float64), on_cpu.flat_params(np.float64)
    param_err = max([rel(a, b) for a, b in zip(adapted.gmm_means, on_cpu.gmm_means)]
                    + [rel(getattr(fc, k), getattr(fh, k)) for k in ("V", "M", "b")])
    moved = max(float(np.abs(a - b).max()) for a, b in zip(adapted.gmm_means, models.gmm_means))
    if not param_err <= PARAM_TOL or not moved > 0:
        raise RuntimeError(f"[20k audio] adapted parameters, card against CPU: {param_err}; "
                           f"means moved {moved}")
    scorer = make_gmm_scorer(adapted.flat_params(), device="cuda")
    n0 = (gmm_cuda.counter.launches, fused_scan.counter.launches)
    scs = [scorer(feats[b, :n]) for b, n in enumerate(lengths)]
    t_max = max(lengths)
    padded = torch.stack([torch.cat([x, x[-1:].expand(t_max - len(x), -1)]) for x in scs])
    results = BatchDecoder(dec).decode_scores_batch(padded, list(lengths))
    launches = (gmm_cuda.counter.launches - n0[0], fused_scan.counter.launches - n0[1])
    n_ov = sum(r.overflow for r in results)
    dead = sum(r.empty for r in results)
    print(f"[20k audio] {len(waves)} utterances of audio (seed {AUDIO_SEED}, made in "
          f"{t_make:.2f}s on the host), T={list(lengths)}: the batched front end on the card "
          f"({feats.shape[0]} x {feats.shape[1]} x {feats.shape[2]}, {t_front:.4f}s) against "
          f"mfcc of each utterance on the CPU, max |err| {front_err:.3e} (atol {FRONT_ATOL}); "
          f"MLLR (2 classes, 2 transforms) on the card in {t_mllr:.4f}s, its float64 means and "
          f"flat parameters {param_err:.3e} from the CPU's (tolerance {PARAM_TOL}, relative "
          f"above 1), the means moved up to {moved:.3f}; BatchDecoder launches gmm_logsumexp "
          f"{launches[0]}, frame_step {launches[1]}; overflow {n_ov}/{len(results)}, dead "
          f"{dead}/{len(results)}, words {[len(r.words) for r in results]}, peak active "
          f"{max(r.max_active for r in results)}, peak candidates "
          f"{max(r.max_cand for r in results)} | {card}", flush=True)
    return dict(waves=waves, base=base, mllr=mllr, results=results, overflow=n_ov)


def phase_cli_audio_20k(card, base, td, lib, markers, phase_done):
    """[cli audio 20k]: the slice's full-width path in one CLI call: the
    16 wav files of `audio_library` with `-inputFormat factory`, the
    base-class file and MLLRMEAN set of `mllr_texts`, `-batchSize 16` at
    `WSJ_POINT`, in [cli 20k]'s directory (its network text, symbols, MMF
    and lexicon). Held: route `frame_step kernel`, the front end on the
    card, launches gmm_logsumexp 16 and frame_step 1, every utterance's
    words, word-end frames and score equal to the library's bit for bit,
    the CLI's overflow warnings equal to the library's overflow count.
    Returns the launches, the overflow count and the CLI's stages."""
    import torch

    from juicer_tpu_torch.harness import wsj_task

    gc.collect()
    torch.cuda.empty_cache()
    p = wsj_task.WSJ_POINT
    names = [f"a{i:02d}" for i in range(len(lib["waves"]))]
    for name, pcm in zip(names, lib["waves"]):
        write_wav(os.path.join(td, f"{name}.wav"), pcm)
    with open(os.path.join(td, "audio.lst"), "w") as fd:
        fd.write("".join(f"{n}={os.path.join(td, n + '.wav')}\n" for n in names))
    for name, text in (("two.base", lib["base"]), ("spk.mllr", lib["mllr"])):
        with open(os.path.join(td, name), "w") as fd:
            fd.write(text)
    out = os.path.join(td, "audio_out.txt")
    argv = [a if a != os.path.join(td, "in.lst") else os.path.join(td, "audio.lst")
            for a in base]
    argv += ["-inputFormat", "factory", "-mllrXformFile", os.path.join(td, "spk.mllr"),
             "-regClassFile", os.path.join(td, "two.base"), "-removeSentMarks",
             "-batchSize", str(len(names)), "-mainBeam", str(p["beam"]), "-phoneEndBeam",
             str(p["end_beam"]), "-wordEmitBeam", str(p["end_beam"]), "-maxHyps",
             str(p["maxhyps"]), "-maxInsts", str(p["K"]), "-expandBudget", str(p["E"]),
             "-outputFormat", "verbose", "-outputFName", out]
    report, launches, n_ov = run_cli(argv)
    front = "front end: MFCC of wav files, a batch in one pass on cuda"
    if report.route != "route: frame_step kernel" or not report.front_end.startswith(front):
        raise RuntimeError(f"[cli audio 20k] {report.route!r}, {report.front_end!r}")
    if launches != (len(names), 1):
        raise RuntimeError(f"[cli audio 20k] launches gmm_logsumexp, frame_step {launches}; "
                           f"expected {len(names)} and 1")
    n_held = same_as_library("cli audio 20k", report.results, lib["results"], markers)
    if n_ov != lib["overflow"]:
        raise RuntimeError(f"[cli audio 20k] {n_ov} overflow warnings, the library "
                           f"{lib['overflow']} overflowing utterances")
    st = report.stages
    print(f"[cli audio 20k] -inputFormat factory -mllrXformFile -regClassFile -batchSize "
          f"{len(names)}: {report.route}; {report.front_end}; launches gmm_logsumexp "
          f"{launches[0]}, frame_step {launches[1]}; words, word-end frames and scores of all "
          f"{n_held} utterances equal the library's (the same card features and adapted "
          f"models through BatchDecoder) bit for bit; overflow {n_ov}/{len(names)} (as the "
          f"library's); seconds: "
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items()) + f" | {card}", flush=True)
    phase_done("cli audio 20k")
    return dict(launches=launches, overflow=n_ov, stages=dict(st))


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        clean_up()
