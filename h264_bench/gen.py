"""The benchmark's one traffic generator: frames from a traffic file's
layers and a seed, made on the device in a few large calls.

A traffic file (traffic/<name>.json) lists `layers`, painted in order on
every frame's luma, and a `chroma` rule. Frame f = 0 is the IDR's picture;
frames 1..ring_frames are the ring the P frames cycle through (a ring as
long as the GOP's P frames repeats no picture inside a GOP). The seed draws
only the random parts (the texture's phases, the noise, the glyphs and the
text); spectra, sizes, contrast, motion and scroll speed come from the
file, so that two seeds cost about the same work.

Layers:
  texture       a field with the power spectrum of natural images, its
                amplitude falling as 1/f**`exponent` (Field 1987: 1), of
                fixed amplitudes with phases drawn from the seed, periodic
                over the picture; set to `mean` and `sigma`; panned
                `pan_px_per_frame` (x, y) px a frame by an exact shift of
                its phases (what a camera sampling a band-limited scene
                sees; the pan wraps over the periodic field without a
                seam).
  invert_block  a `size` square at `start` + f * `step` (x, y), wrapped in
                the picture, inverted (255 - sample).
  noise         Gaussian sensor noise of `sigma`, fresh on every frame.
  fill          every sample set to `level`.
  rect          `box` (x, y, w, h) set to `level`.
  text          `box` filled with `paper`, and rows of `glyph` (w, h) glyphs
                in `ink`, drawn from a seeded atlas of `glyphs` bitmaps with
                a fixed share `density` of ink, rows filled to fixed lengths
                around `line_fill`; the text scrolls up
                `scroll_px_per_frame`, seamlessly over the ring.
Chroma (u, v) = luma subsampled 2:1, times a / b, plus c, for (a, b, c).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str, bench: str = HERE) -> dict:
    """traffic/<name>.json of the benchmark's folder `bench`."""
    with open(os.path.join(bench, "traffic", f"{name}.json")) as f:
        return json.load(f)


def _texture(layer, H, W, n, g, dev):
    pan_x, pan_y = layer["pan_px_per_frame"]
    ky = torch.fft.fftfreq(H, dtype=torch.float64, device=dev)[:, None]
    kx = torch.fft.rfftfreq(W, dtype=torch.float64, device=dev)[None, :]
    f = torch.sqrt(kx * kx + ky * ky)
    amp = f.clamp_min(1.0 / max(H, W)) ** -float(layer["exponent"])
    amp[0, 0] = 0.0  # the mean is set below
    # A Nyquist bin cannot shift by a fraction of a pel: none.
    if W % 2 == 0:
        amp[:, -1] = 0.0
    if H % 2 == 0:
        amp[H // 2, :] = 0.0
    spec = torch.fft.rfft2(torch.randn((H, W), generator=g, device=dev))
    spec = spec / spec.abs().clamp_min(1e-30) * amp.float()
    base = torch.fft.irfft2(spec, s=(H, W))
    gain = float(layer["sigma"]) / float(base.std())
    mean = float(layer["mean"])

    def frame(fi, y):
        # Frame fi shows the field at (x + pan_x fi, y + pan_y fi).
        turns = torch.remainder(kx * (pan_x * fi) + ky * (pan_y * fi), 1.0)
        shift = torch.polar(torch.ones_like(turns),
                            2 * math.pi * turns).to(torch.complex64)
        y.copy_(torch.fft.irfft2(spec * shift, s=(H, W)) * gain + mean)
    return frame


def _invert_block(layer, H, W, n, g, dev):
    s = int(layer["size"])
    (x0, y0), (sx, sy) = layer["start"], layer["step"]

    def frame(f, y):
        bx = (x0 + sx * f) % max(W - s, 1)
        by = (y0 + sy * f) % max(H - s, 1)
        y[by:by + s, bx:bx + s] = 255.0 - y[by:by + s, bx:bx + s]
    return frame


def _noise(layer, H, W, n, g, dev):
    sigma = float(layer["sigma"])

    def frame(f, y):
        y.add_(torch.randn((H, W), generator=g, device=dev), alpha=sigma)
    return frame


def _fill(layer, H, W, n, g, dev):
    def frame(f, y):
        y.fill_(float(layer["level"]))
    return frame


def _rect(layer, H, W, n, g, dev):
    x, y0, w, h = layer["box"]

    def frame(f, y):
        y[y0:y0 + h, x:x + w] = float(layer["level"])
    return frame


def _text(layer, H, W, n, g, dev):
    x, y0, w, h = layer["box"]
    gw, gh = layer["glyph"]
    scroll = int(layer["scroll_px_per_frame"])
    period = scroll * n  # canvas rows: the text repeats after the ring
    if period % gh:
        raise ValueError("scroll x ring_frames must be whole glyph rows")
    n_glyphs = int(layer["glyphs"])
    # Glyph atlas: each bitmap has the same number of ink pixels inside a
    # margin of one column right and 3 rows above and below.
    inner = (gh - 6) * (gw - 1)
    ink_px = int(round(float(layer["density"]) * inner))
    order = torch.argsort(torch.rand((n_glyphs, inner), generator=g,
                                     device=dev), dim=1)
    ink = (order < ink_px).reshape(n_glyphs, gh - 6, gw - 1)
    atlas = torch.zeros((n_glyphs + 1, gh, gw), dtype=torch.bool, device=dev)
    atlas[1:, 3:gh - 3, 0:gw - 1] = ink  # glyph 0 is a blank
    rows, cols = period // gh, w // gw
    # Fixed line lengths: the same on every seed.
    fill = float(layer["line_fill"])
    lengths = [int(cols * min(1.0, fill * (0.7 + 0.6 * ((7 * i) % rows)
                                           / max(rows - 1, 1))))
               for i in range(rows)]
    idx = torch.randint(1, n_glyphs + 1, (rows, cols), generator=g,
                        device=dev)
    col = torch.arange(cols, device=dev)[None, :]
    idx = torch.where(col < torch.tensor(lengths, device=dev)[:, None], idx, 0)
    canvas = atlas[idx].permute(0, 2, 1, 3).reshape(period, cols * gw)
    canvas = torch.where(canvas, float(layer["ink"]), float(layer["paper"]))
    full = torch.full((period, w), float(layer["paper"]), device=dev)
    full[:, :cols * gw] = canvas
    ar = torch.arange(h, device=dev)

    def frame(f, y):
        y[y0:y0 + h, x:x + w] = full[(ar + scroll * f) % period]
    return frame


LAYERS = {"texture": _texture, "invert_block": _invert_block,
          "noise": _noise, "fill": _fill, "rect": _rect, "text": _text}


def make_frames(traffic: dict, width: int, height: int, seed: int,
                device) -> list:
    """Frames 0..ring_frames as (y, u, v) uint8 tensors on `device`."""
    dev = torch.device(device)
    n = int(traffic["ring_frames"])
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) % (1 << 63))
    painters = [LAYERS[layer["kind"]](layer, height, width, n, g, dev)
                for layer in traffic["layers"]]
    (ua, ub, uc), (va, vb, vc) = traffic["chroma"]["u"], traffic["chroma"]["v"]
    frames = []
    y = torch.zeros((height, width), dtype=torch.float32, device=dev)
    for f in range(n + 1):
        y.zero_()
        for paint in painters:
            paint(f, y)
        y8 = y.round().clamp(0, 255).to(torch.uint8)
        sub = y8[::2, ::2].to(torch.int32)
        frames.append((y8, (sub * ua // ub + uc).clamp(0, 255).to(torch.uint8),
                       (sub * va // vb + vc).clamp(0, 255).to(torch.uint8)))
    return frames


def to_host(frames) -> list:
    """The frames as (y, u, v) uint8 numpy planes."""
    return [tuple(p.cpu().numpy() for p in fr) for fr in frames]


def i420(planes) -> bytes:
    return b"".join(np.ascontiguousarray(p).tobytes() for p in planes)
