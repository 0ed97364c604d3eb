"""decode_mfu: the model's own work, 4 * D operations for every real
Gaussian component of every GMM at every true frame decoded in the window
without failing, over the window's seconds and the card's float32 peak,
in %. It counts the arithmetic the acoustic model needs, whatever does it."""

from pb.opcount import gmm_flops


def read(run):
    if run.peaks is None:
        return None
    frames = sum(w.frames for w in run.waves)
    flops = gmm_flops(frames, run.model["components"], run.model["D"])
    return 100.0 * flops / (run.window_s * run.peaks["f32_flops"])
