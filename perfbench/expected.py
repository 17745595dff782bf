"""What the check expects of each content: the plain reference's output,
worked out again from the seed after the window.

``pixels`` is the reference's decode of the quantized blocks the corpus
encoded; ``segments`` the reference's encode of the corpus's pixels, in
float32 on ``device`` and entropy-coded on the host.  With
``tf32=True`` each is the control: the reference with TF32 products.
"""

from __future__ import annotations

from typing import List

import torch

from . import corpus


def pixels(cell, seed: int, device, tf32: bool = False) -> torch.Tensor:
    """[contents, H, W, 3] uint8 on ``device``."""
    ref = cell.reference
    geom = ref.geometry_of(cell.config)
    out = []
    for i in range(cell.traffic["contents"]):
        planes = corpus.planes(cell.config, seed, i)
        blocks = [torch.from_numpy(p).to(device, torch.int32)[None]
                  for p in planes]
        out.append(ref.inverse(blocks, int(cell.config["quality"]), geom,
                               tf32=tf32)[0])
    return torch.stack(out)


def segments(cell, seed: int, device, tf32: bool = False) -> List[List[bytes]]:
    """Each content's entropy-coded segments, as the reference encodes
    the corpus's pixels."""
    ref = cell.reference
    cfg = cell.config
    geom = ref.geometry_of(cfg)
    out = []
    for i in range(cell.traffic["contents"]):
        rgb = torch.from_numpy(corpus.content(seed, i, geom.width,
                                              geom.height)).to(device)
        planes = [p[0].cpu().numpy() for p in
                  ref.forward(rgb[None], int(cfg["quality"]), geom,
                              dtype=torch.float32, tf32=tf32)]
        out.append(ref.encode_segments(planes, geom,
                                       int(cfg["restart_interval"])))
    return out


def frames(cell, seed: int, device, tf32: bool = False) -> List[bytes]:
    """Each content as a whole frame of the reference's encode."""
    ref = cell.reference
    cfg = cell.config
    header = ref.frame_header(ref.geometry_of(cfg), int(cfg["quality"]),
                              int(cfg["restart_interval"]))
    return [ref.join_frame(header, s)
            for s in segments(cell, seed, device, tf32)]
