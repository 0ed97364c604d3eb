"""frame_step_roofline: the frame step's share of its roofline over the
traced window: the least time the card could take for the window's waves
(`pb.stepcount`, from each fused `entry` span's B, T, K and S, the model's G,
and the counters `candidates`, `active_slot_frames` and `records` of the
entry's `copy` spans) over the device time of the kernels whose name
holds `frame_step`, clipped to the window, in %. Nothing where the
program records no spans or counters, the trace holds no such kernel, or
the card has no peak in the table."""

from pb import intervals, program_trace
from pb.stepcount import frame_step_bound_s

COUNTS = ("candidates", "active_slot_frames", "records")


def read(run):
    pt = program_trace.of(run)
    if pt is None or run.peaks is None:
        return None
    lo, hi = run.trace.window
    busy = sum(e - s for s, e in intervals.clip(run.trace.device_intervals("frame_step"),
                                                 lo, hi))
    copies = {}
    for sp in pt.spans:
        if sp.name == "copy":
            copies.setdefault(sp.parent, []).append(sp.attrs)
    bound = 0.0
    for sp in pt.spans:
        a = sp.attrs
        if sp.name != "entry" or a.get("route") != "fused":
            continue
        mine = copies.get(sp.id, [])
        if not mine or any(k not in c for c in mine for k in COUNTS):
            continue
        n = [sum(c[k] for c in mine) for k in COUNTS]
        bound += frame_step_bound_s(a["B"], a["T"], a["K"], a["S"], run.model["G"], *n,
                                    run.peaks)
    return 100.0 * bound / busy if busy > 0 and bound > 0 else None
