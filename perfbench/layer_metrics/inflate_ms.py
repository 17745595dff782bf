"""inflate_ms.* (``inflate_ms.ri7``): the ``device_decode.inflate`` span
(the frame-major redo of a "mats" chunk whose lanes outran their phase
budgets: its prep, dispatch and host read), ms a frame.  Reads 0.0 where
"mats" chunks ran in the window and none was redone; nothing where none
ran, or where the program has neither the span nor the
``device_decode.lane_order_frames`` counter that came with it."""

from perfbench import readers

SPAN = "device_decode.inflate"


def read(run):
    c = run.window.counters
    if not c.get("device_decode.mats_chunks") or (
            SPAN not in run.window.spans
            and "device_decode.lane_order_frames" not in c):
        return None
    return readers.span_ms_per_frame(run, SPAN) or 0.0
