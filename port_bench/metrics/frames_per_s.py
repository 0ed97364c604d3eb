"""frames_per_s: true frames (100 = 1 s of audio) of every utterance whose
words came back in the window without failing (no overflow flag, a final
state), over the window's seconds (host clock, whole waves)."""


def read(run):
    return sum(w.frames for w in run.waves) / run.window_s
