"""Live terminal preview: the reference's progressive display without a
display server.

The reference blits the accumulating film into a GLFW window every frame
(src/main.cpp:21-36). Here the film is drawn as ANSI 24-bit half-block
cells (each character cell shows two vertical pixels: the upper-half-block
glyph's foreground is the top pixel, its background the bottom one),
through the PNG writer's tonemap (mean -> clamp -> gamma 1/2,
src/Scene.cpp:26-30), box-downsampled to fit the terminal.
`python -m mcpt_tpu_torch render --live` redraws it after every pass.
Copied from mcpt_tpu/io/term.py: for the same film both give the same
string.
"""
from __future__ import annotations

import numpy as np

HOME = "\x1b[H"
CLEAR = "\x1b[2J"
RESET = "\x1b[0m"


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


def tonemap_u8(accum, spp) -> np.ndarray:
    """Film accumulators -> display u8 [H,W,3], image top-first: the one
    tonemap of io/image.py, then the save's flip (film row 0 is the image
    bottom)."""
    from mcpt_tpu_torch.io.image import tonemap

    spp = np.asarray(spp, np.float32)
    if spp.ndim == 2:
        spp = spp[..., None]
    return tonemap(_numpy(accum), spp)[::-1]


def _box_downsample(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    H, W, _ = img.shape
    ys = (np.arange(out_h + 1) * H // out_h).astype(np.int64)
    xs = (np.arange(out_w + 1) * W // out_w).astype(np.int64)
    out = np.empty((out_h, out_w, 3), np.float32)
    csum = np.zeros((H + 1, W + 1, 3), np.float64)
    csum[1:, 1:] = np.cumsum(np.cumsum(img.astype(np.float64), 0), 1)
    for i in range(out_h):
        y0, y1 = ys[i], max(ys[i + 1], ys[i] + 1)
        for j in range(out_w):
            x0, x1 = xs[j], max(xs[j + 1], xs[j] + 1)
            area = (y1 - y0) * (x1 - x0)
            out[i, j] = (
                csum[y1, x1] - csum[y0, x1] - csum[y1, x0] + csum[y0, x0]
            ) / area
    return out.astype(np.uint8)


def ansi_frame(film, max_cols: int = 96, max_rows: int = 28) -> str:
    """One ANSI frame of the film (print it with flush). max_rows counts
    character rows, each showing two pixel rows."""
    img = tonemap_u8(film.accum, film.spp)
    H, W, _ = img.shape
    scale = max(1e-9, min(max_cols / W, (2 * max_rows) / H, 1.0))
    out_w = max(2, int(W * scale))
    out_h = max(2, int(H * scale)) & ~1  # even (pairs of pixel rows)
    small = _box_downsample(img, out_h, out_w) if (out_h, out_w) != (H, W) \
        else img
    lines = []
    for y in range(0, small.shape[0], 2):
        top = small[y]
        bot = small[y + 1]
        cells = [
            f"\x1b[38;2;{t[0]};{t[1]};{t[2]}m\x1b[48;2;{b[0]};{b[1]};{b[2]}m▀"
            for t, b in zip(top, bot)
        ]
        lines.append("".join(cells) + RESET)
    return "\n".join(lines)


def live_draw(film, spp: int, total_spp: int, pass_ms: float,
              first: bool = False, out=None) -> None:
    """Redraw the preview in place (cursor home, no scroll)."""
    import sys

    out = out or sys.stdout
    if first:
        out.write(CLEAR)
    out.write(HOME)
    out.write(ansi_frame(film))
    out.write(
        f"\n{RESET}[live] {spp}/{total_spp} spp  {pass_ms:.1f} ms/pass  "
        "(ESC analog: ctrl-C saves nothing; the final PNG is written at "
        "the end)\n"
    )
    out.flush()
