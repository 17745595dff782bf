"""Driver: clips of a feed on a decoder kept from set-up, in the native
prep mode the traffic names (``prep_mode``).

As ``kept_decode``, whose helpers it takes: set-up builds
``jpeg_tpu_torch.DeviceDecoder.for_stream(first frame, device)`` once,
and each call is ``decoder.decode_batch(frames, chunk)`` of the next
``clip_frames`` frames of the feed (the corpus's contents in seeded
orders), closed loop, one caller.  Here the decoder's ``prep_mode`` is
set before its first call: "rows" writes the zero-padded lane matrix,
the only prep in which the decoder learns and keeps a lane order ("auto"
takes the flat prep on the card, which never sorts).  The warm-up calls
hold the first batch, which learns the order, so every timed call runs
in it.  The check holds each sampled frame against the plain reference's
pixels of its content.
"""

from __future__ import annotations

from pathlib import Path

import torch

from perfbench import corpus
from perfbench.cell import load_module

_kept = load_module(Path(__file__).with_name("kept_decode.py"))
KIND = _kept.KIND
make_inputs = _kept.make_inputs


class Driver(_kept.Driver):
    def __init__(self, cell, seed: int, device, frames, log):
        from jpeg_tpu_torch import DeviceDecoder

        t = cell.traffic
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.order = [int(c) for o in corpus.clip_orders(
            seed, t["contents"], t["contents"], t["clips"]) for c in o]
        self.frames = frames
        self.chunk = int(t["chunk"])
        self.frames_per_call = int(t["clip_frames"])
        self.pixels_per_call = self.frames_per_call * int(
            cell.config["width"]) * int(cell.config["height"])
        self.dec = DeviceDecoder.for_stream(frames[self.order[0]], self.device)
        self.dec.prep_mode = t["prep_mode"]
        self._want = None
        for i in range(int(t["warm_calls"])):
            self.call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"feed: {len(self.order)} frames in turn, "
            f"{self.frames_per_call} a call, {self.dec.prep_mode} prep, "
            f"lane order learned: {self.dec.sort_order is not None}")
