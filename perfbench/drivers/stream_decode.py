"""Driver: a Motion-JPEG clip from bytes to pixels on the card.

Each call is ``jpeg_tpu_torch.mjpeg.decode_stream_device(clip, device,
chunk)`` on one clip of ``clip_frames`` frames (the frames concatenated,
as a camera's stream arrives), closed loop, one caller.  The window
rotates over ``clips`` clips, each the corpus's contents in another
seeded order.  The check holds every frame of the sampled calls against
the plain reference's pixels of its content.
"""

from __future__ import annotations

import torch

from perfbench import corpus, expected, judge, roofline

KIND = "decode"


def make_inputs(cell, seed: int):
    return corpus.frames(cell.config, seed, cell.traffic["contents"])


class Driver:
    def __init__(self, cell, seed: int, device, frames, log):
        from jpeg_tpu_torch import mjpeg

        t = cell.traffic
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.decode = mjpeg.decode_stream_device
        self.chunk = int(t["chunk"])
        self.orders = corpus.clip_orders(seed, t["contents"], t["clip_frames"],
                                         t["clips"])
        self.clips = [b"".join(frames[c] for c in o) for o in self.orders]
        self.frames_per_call = int(t["clip_frames"])
        self.pixels_per_call = self.frames_per_call * int(
            cell.config["width"]) * int(cell.config["height"])
        self._want = None
        for i in range(int(t["warm_calls"])):
            self.call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"clips: {len(self.clips)} of {self.frames_per_call} frames, "
            f"{[len(c) for c in self.clips]} bytes")

    def call(self, i: int):
        return self.decode(self.clips[i % len(self.clips)], self.device,
                           chunk=self.chunk)

    def contents(self, i: int):
        return [int(c) for c in self.orders[i % len(self.orders)]]

    def work(self, i: int, out):
        return roofline.decode_bytes(len(self.clips[i % len(self.clips)]),
                                     self.pixels_per_call)

    def close(self) -> None:
        self.clips = None

    def judge(self, samples) -> dict:
        if self._want is None:
            self._want = expected.pixels(self.cell, self.seed, self.device)
        return judge.judge_pixels(
            [(out, self.contents(i)) for i, out in samples], self._want)

    def control(self, calls):
        """The reference with TF32 products, in the program's place:
        [(i, output)] for calls ``calls``."""
        low = expected.pixels(self.cell, self.seed, self.device, tf32=True)
        return [(i, low[self.contents(i)]) for i in calls]
