"""Host-side image helpers (the port's own copy of the JAX package's
``utils/image.py`` and ``data/pie_bench.load_image``): input loading, the
prompt panel and the 4-panel result strip
[instruction | ground truth | reconstruction | edit], all uint8 (H, W, 3).
"""
from __future__ import annotations

import textwrap
from typing import Sequence

import numpy as np
from PIL import Image, ImageDraw


def load_image(image_path, size: int = 512) -> np.ndarray:
    """A path or an (H, W, >=3) array, centre-cropped to a square and resized
    to size x size RGB uint8."""
    if isinstance(image_path, str):
        image = np.array(Image.open(image_path))[:, :, :3]
    else:
        image = np.asarray(image_path)
    h, w, _ = image.shape
    if h < w:
        offset = (w - h) // 2
        image = image[:, offset : offset + h]
    elif w < h:
        offset = (h - w) // 2
        image = image[offset : offset + w]
    if image.shape[:2] != (size, size):
        image = np.array(Image.fromarray(image).resize((size, size)))
    return image


def txt_draw(text: str, target_size=(512, 512)) -> np.ndarray:
    """Render text into an RGB uint8 panel. With matplotlib installed this is
    the JAX package's rendering, pixel for pixel; without it (GPU hosts often
    lack it) the text is drawn with PIL's default font."""
    try:
        import matplotlib
    except ImportError:
        panel = Image.new("RGB", target_size, "white")
        wrapped = "\n".join(textwrap.fill(line, 60) for line in text.split("\n"))
        ImageDraw.Draw(panel).multiline_text((8, 8), wrapped, fill="black")
        return np.asarray(panel)

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_agg import FigureCanvasAgg

    fig = plt.figure(dpi=300, figsize=(1, 1))
    plt.text(-0.1, 1.1, text, fontsize=3.5, wrap=True,
             verticalalignment="top", horizontalalignment="left")
    plt.axis("off")
    canvas = FigureCanvasAgg(fig)
    canvas.draw()
    w, h = canvas.get_width_height()
    buf = np.frombuffer(canvas.buffer_rgba(), dtype=np.uint8).reshape(h, w, 4)
    image = Image.fromarray(buf[:, :, :3]).resize(target_size, Image.LANCZOS)
    plt.close(fig)
    return np.asarray(image)


def make_strip(panels: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate equal-height uint8 panels side by side."""
    return np.concatenate([np.asarray(p) for p in panels], axis=1)
