"""Driver: frames that live on the card, encoded to JPEG bytes.

Set-up builds ``jpeg_tpu_torch.DeviceEncoder.for_config`` once for the
configuration (its quality, sampling and restart interval, the Annex K
tables) and uploads ``clips`` clips of ``clip_frames`` frames, each the
corpus's contents in a seeded order, as [F, H, W, 3] uint8.  Each call
is ``encoder.encode_batch(clip, optimize, chunk)`` -> ``List[bytes]``,
closed loop, one caller.  The check reads every frame of the sampled
calls back against the plain reference's encode of its content.
"""

from __future__ import annotations

import torch

from perfbench import corpus, expected, judge, roofline

KIND = "encode"


def make_inputs(cell, seed: int):
    return corpus.pixels(cell.config, seed, cell.traffic["contents"])


class Driver:
    def __init__(self, cell, seed: int, device, pixels, log):
        from jpeg_tpu_torch import DeviceEncoder, EncodeParams

        t, cfg = cell.traffic, cell.config
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        geom = cell.reference.geometry_of(cfg)
        self.enc = DeviceEncoder.for_config(
            geom.height, geom.width, 3, EncodeParams(
                h=geom.h, v=geom.v, quality=int(cfg["quality"]),
                optimize=False, exact=False,
                restart_interval=int(cfg["restart_interval"])),
            device=self.device)
        self.optimize = bool(t["optimize"])
        self.chunk = int(t["chunk"])
        self.orders = corpus.clip_orders(seed, t["contents"], t["clip_frames"],
                                         t["clips"])
        host = torch.from_numpy(pixels)
        self.clips = [host[torch.from_numpy(o)].to(self.device)
                      for o in self.orders]
        self.frames_per_call = int(t["clip_frames"])
        self.pixels_per_call = self.frames_per_call * geom.width * geom.height
        self._want = None
        for i in range(int(t["warm_calls"])):
            self.call(i)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        log(f"clips: {len(self.clips)} of {self.frames_per_call} frames on "
            f"{self.device}")

    def call(self, i: int):
        return self.enc.encode_batch(self.clips[i % len(self.clips)],
                                     optimize=self.optimize, chunk=self.chunk)

    def contents(self, i: int):
        return [int(c) for c in self.orders[i % len(self.orders)]]

    def work(self, i: int, out):
        return roofline.encode_bytes(self.pixels_per_call,
                                     sum(len(f) for f in out))

    def close(self) -> None:
        self.enc = self.clips = None

    def judge(self, samples) -> dict:
        if self._want is None:
            self._want = expected.segments(self.cell, self.seed, self.device)
        return judge.judge_frames(
            self.cell.reference,
            [(out, self.contents(i)) for i, out in samples], self._want,
            self.cell.config, self.seed)

    def control(self, calls):
        """The reference with TF32 products, in the program's place."""
        low = expected.frames(self.cell, self.seed, self.device, tf32=True)
        return [(i, [low[c] for c in self.contents(i)]) for i in calls]
