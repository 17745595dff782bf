"""decode_Mpix_s: every pixel decoded in the window over the window's
seconds (host clock; each call closed by a device synchronize)."""

from perfbench import readers, stats


def read(run):
    if run.kind != "decode":
        return None
    return stats.rate(readers.frames(run) * run.pixels_per_call
                      / run.frames_per_call, run.window.seconds) / 1e6
