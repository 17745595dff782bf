"""spec_refused_share.* (``spec_refused_share.rstless``): the share of frames the speculative
engine refused as a batch (``mjpeg.rstless_batch_fallbacks`` batches of
the traffic's ``chunk`` frames), which then took a per-frame retry and,
where that was refused too, the host rung, over the frames the window's
calls attempted, percent.

Exact only where a call's frames are a whole number of chunks, so that
every batch holds ``chunk`` frames; elsewhere it reads nothing.
``mjpeg.rstless_host_frames`` counts frames inside refused batches again
(the host rung follows a refused retry), and ``speculative.fallbacks``
counts refusals at both rungs, a batch's and each retried frame's: adding
either would count a frame twice.  Reads nothing where the engine did not
run.
"""

def read(run):
    c = run.window.counters
    if not c.get("speculative.batches"):
        return None
    chunk = int(run.cell.traffic["chunk"])
    if run.frames_per_call % chunk:
        return None
    attempted = run.window.calls * run.frames_per_call
    refused = c.get("mjpeg.rstless_batch_fallbacks", 0) * chunk
    return 100.0 * refused / attempted
