"""copy_mb: the bytes the program's `copy` spans copied to the host
(their counter `dtoh_bytes`), summed per traced wave, as a mean over the
waves, in 1e6 bytes. Nothing where the program records no spans."""

from pb import program_trace


def read(run):
    pt = program_trace.of(run)
    if pt is None:
        return None
    per_wave = [sum(sp.attrs.get("dtoh_bytes", 0) for sp in copies)
                for copies in pt.by_wave("copy").values()]
    return sum(per_wave) / len(per_wave) / 1e6 if per_wave else None
