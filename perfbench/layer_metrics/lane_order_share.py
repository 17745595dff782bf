"""lane_order_share.* (``lane_order_share.ri7``): the frames the window
decoded in a kept decoder's learned lane order (the
``device_decode.lane_order_frames`` counter: frames of the "mats" chunks
that stood, not redone frame-major) over the frames its calls decoded,
percent.  Reads nothing where no "rows" chunk ran in the window (the
flat prep never sorts), or where the program has no such counter."""

from perfbench import readers

COUNTER = "device_decode.lane_order_frames"


def read(run):
    c = run.window.counters
    frames = readers.frames(run)
    if COUNTER not in c or not c.get("device_decode.rows_prep_chunks") \
            or not frames:
        return None
    return 100.0 * c[COUNTER] / frames
