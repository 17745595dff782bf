"""Driver: a live feed, one frame a call, on a decoder kept from set-up.

Set-up builds ``jpeg_tpu_torch.DeviceDecoder.for_stream(first frame,
device)`` once; each call is ``decoder.decode_batch([frame])`` of the
next frame of the feed (the corpus's contents in seeded orders), closed
loop, one caller.  The check holds each sampled frame against the plain
reference's pixels of its content.
"""

from __future__ import annotations

import torch

from perfbench import corpus, expected, judge, roofline

KIND = "decode"


def make_inputs(cell, seed: int):
    return corpus.frames(cell.config, seed, cell.traffic["contents"])


class Driver:
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
        self._want = None
        for i in range(int(t["warm_calls"])):
            self.call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"feed: {len(self.order)} frames in turn, "
            f"{self.frames_per_call} a call")

    def _frames(self, i: int):
        n = self.frames_per_call
        return [self.order[(i * n + k) % len(self.order)] for k in range(n)]

    def call(self, i: int):
        return self.dec.decode_batch([self.frames[c] for c in self._frames(i)],
                                     chunk=self.chunk)

    def contents(self, i: int):
        return self._frames(i)

    def work(self, i: int, out):
        return roofline.decode_bytes(
            sum(len(self.frames[c]) for c in self._frames(i)),
            self.pixels_per_call)

    def close(self) -> None:
        self.dec = None

    def judge(self, samples) -> dict:
        if self._want is None:
            self._want = expected.pixels(self.cell, self.seed, self.device)
        return judge.judge_pixels(
            [(out, self.contents(i)) for i, out in samples], self._want)

    def control(self, calls):
        low = expected.pixels(self.cell, self.seed, self.device, tf32=True)
        return [(i, low[self.contents(i)]) for i in calls]
