"""Weight-filter mosaics and reconstruction renders of the port
(counterpart: ``deeplearning4j_tpu/plot/filters.py`` — ``PlotFilters``,
``render_image``, ``image_png_bytes``, ``reconstruct``,
``ReconstructionRender`` and ``PlotFiltersIterationListener``).

Host numpy, as in the JAX package: filters tiled into one mosaic (each
tile scaled to [0, 1]; a 2-D input is one matrix, a 4-D one up to four
channel slices), written as PNG through PIL, imported when a render is
written. ``reconstruct`` encodes through the pretrain layers of a port
MultiLayerNetwork on its device and decodes with the chosen layer's
visible model (an AutoEncoder's decoder, an RBM's visible mean); the
result comes back as numpy. The listener is an ``IterationListener`` of
``optimize/listeners.py``.
"""

from __future__ import annotations

import io
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.optimize.listeners import IterationListener

__all__ = [
    "PlotFilters",
    "PlotFiltersIterationListener",
    "ReconstructionRender",
    "reconstruct",
    "render_image",
]


def _scale01(a: np.ndarray) -> np.ndarray:
    """Min-max scaling of one image to [0, 1] (zeros if it is flat)."""
    a = a.astype(np.float64)
    lo = a.min()
    rng = a.max() - lo
    return (a - lo) / rng if rng > 0 else np.zeros_like(a)


class PlotFilters:
    """Tile filters into one mosaic array.

    input: [n_filters, h*w] (one matrix — the RBM/AE "transposed nout x nin"
    case) or [channels, n_filters, h, w] (4d, up to 4 channel slices).
    tile_shape: tiles (rows, cols) in the mosaic; tile_spacing: gap pixels
    between tiles; image_shape: (h, w) of one filter image."""

    def __init__(self, input: Optional[np.ndarray],
                 tile_shape: Tuple[int, int] = (10, 10),
                 tile_spacing: Tuple[int, int] = (0, 0),
                 image_shape: Tuple[int, int] = (28, 28),
                 scale_rows: bool = True):
        self.input = None if input is None else np.asarray(input)
        self.tile_shape = tuple(tile_shape)
        self.tile_spacing = tuple(tile_spacing)
        self.image_shape = tuple(image_shape)
        self.scale_rows = scale_rows
        self._plot: Optional[np.ndarray] = None

    def set_input(self, input) -> None:
        self.input = np.asarray(input)

    def _section(self, mat: np.ndarray) -> np.ndarray:
        """One [n, h*w] matrix -> [H, W] mosaic, vectorized: pad to a full
        tile grid, reshape to (tr, tc, h, w), then interleave spacing."""
        th, tw = self.tile_shape
        h, w = self.image_shape
        hs, ws = self.tile_spacing
        n = min(mat.shape[0], th * tw)
        imgs = mat[:n].reshape(n, h, w)
        if self.scale_rows:
            imgs = np.stack([_scale01(im) for im in imgs])
        full = np.zeros((th * tw, h, w), imgs.dtype)
        full[:n] = imgs
        # grid assembly: (tr, tc, h, w) -> (tr, h, tc, w) -> 2D
        grid = full.reshape(th, tw, h, w).transpose(0, 2, 1, 3)
        if hs or ws:
            padded = np.zeros((th, h + hs, tw, w + ws), imgs.dtype)
            padded[:, :h, :, :w] = grid
            out = padded.reshape(th * (h + hs), tw * (w + ws))
            return out[: th * (h + hs) - hs or None,
                       : tw * (w + ws) - ws or None]
        return grid.reshape(th * h, tw * w)

    def plot(self) -> np.ndarray:
        if self.input is None:
            raise ValueError("set_input first")
        if self.input.ndim == 2:
            self._plot = self._section(self.input)
        elif self.input.ndim == 4:
            # up to 4 channel slices stacked as colour planes; a single
            # channel (the MNIST conv case) stays 2d grayscale and 2
            # channels pad to renderable RGB — every plot() result must be
            # consumable by render_image
            sections = [self._section(
                self.input[c].reshape(self.input.shape[1], -1))
                for c in range(min(4, self.input.shape[0]))]
            if len(sections) == 1:
                self._plot = sections[0]
            else:
                if len(sections) == 2:
                    sections.append(np.zeros_like(sections[0]))
                self._plot = np.stack(sections, axis=-1)
        else:
            raise ValueError(f"need 2d or 4d input, got {self.input.ndim}d")
        return self._plot

    def get_plot(self) -> np.ndarray:
        if self._plot is None:
            raise ValueError("call plot() first")  # IllegalStateException
        return self._plot


def _to_uint8(image: np.ndarray) -> np.ndarray:
    a = np.asarray(image, np.float64)
    if a.max() > 1.0 + 1e-9:  # already pixel-valued
        return np.clip(a, 0, 255).astype(np.uint8)
    return np.clip(a * 255.0, 0, 255).astype(np.uint8)


def _to_pil(image: np.ndarray):
    """One validation + mode-selection point for both render paths."""
    from PIL import Image

    a = _to_uint8(image)
    if a.ndim == 2:
        return Image.fromarray(a, "L")
    if a.ndim == 3 and a.shape[-1] in (3, 4):
        return Image.fromarray(a, "RGBA" if a.shape[-1] == 4 else "RGB")
    raise ValueError(f"renderable shapes: [H,W] or [H,W,3/4]; "
                     f"got {a.shape}")


def render_image(image: np.ndarray, path: str) -> None:
    """Array -> PNG file: 2d renders
    grayscale, [H, W, 3/4] renders RGB(A); [0, 1] floats scale to pixels."""
    _to_pil(image).save(path, format="PNG")


def image_png_bytes(image: np.ndarray) -> bytes:
    """The PNG bytes of an image (for a data URI)."""
    buf = io.BytesIO()
    _to_pil(image).save(buf, format="PNG")
    return buf.getvalue()


def reconstruct(net, x, layer: int) -> np.ndarray:
    """Reconstruction through pretrain layer ``layer``: encode through
    layers [0, layer], then decode with that layer's visible model (an
    AutoEncoder's decoder or an RBM's visible mean)."""
    import torch

    impl = net.layers[layer]
    params = net.params[layer]
    if hasattr(impl, "decode"):
        decode = impl.decode
    elif hasattr(impl, "_visible_mean"):
        decode = impl._visible_mean
    else:
        raise ValueError(
            f"layer {layer} ({type(impl).__name__}) has no visible model — "
            "reconstruction needs an AutoEncoder or RBM layer")
    with torch.no_grad():
        acts, _ = net._forward(net.params, net.states, net._as_input(x),
                               train=False, upto=layer + 1)
        return decode(params, acts[-1]).cpu().numpy()


class ReconstructionRender:
    """Real images over their reconstructions, one PNG per batch of the
    iterator: recon_layer < 0 reconstructs with ``network.output``, else
    through pretrain layer recon_layer (:func:`reconstruct`)."""

    def __init__(self, iterator, network, recon_layer: int = -1,
                 image_shape: Tuple[int, int] = (28, 28),
                 max_examples: int = 16):
        self.iter = iterator
        self.network = network
        self.recon_layer = recon_layer
        self.image_shape = tuple(image_shape)
        self.max_examples = max_examples
        self._walk = None  # the iterator, kept across draws

    def draw(self, path: str) -> np.ndarray:
        """Render the next batch: row of real images over the row of their
        reconstructions. Returns the mosaic and writes PNG to `path`.
        Successive calls walk the iterator; StopIteration propagates when it is exhausted."""
        h, w = self.image_shape
        if self._walk is None:
            self._walk = iter(self.iter)
        ds = next(self._walk)
        x = np.asarray(ds.features)[: self.max_examples]
        if self.recon_layer < 0:
            recon = self.network.output(x)
            recon = np.asarray(recon.cpu().numpy() if hasattr(recon, "cpu")
                               else recon)
        else:
            recon = reconstruct(self.network, x, self.recon_layer)
        n = x.shape[0]
        real = np.stack([_scale01(im) for im in x.reshape(n, h, w)])
        rec = np.stack([_scale01(im) for im in recon.reshape(n, h, w)])
        mosaic = np.concatenate([
            real.transpose(1, 0, 2).reshape(h, n * w),
            rec.transpose(1, 0, 2).reshape(h, n * w),
        ])  # [2h, n*w]: top row REAL, bottom row TEST
        render_image(mosaic, path)
        return mosaic


class PlotFiltersIterationListener(IterationListener):
    """Every ``frequency`` iterations: the layer's weight matrix,
    transposed, tiled by ``filters`` and written as a PNG."""

    def __init__(self, filters: PlotFilters, layer: int = 0,
                 param: str = "W", frequency: int = 10,
                 output_path: str = "render.png"):
        self.filters = filters
        self.layer = layer
        self.param = param
        self.frequency = max(1, frequency)
        self.output_path = output_path

    def iteration_done(self, model, iteration: int, score: float) -> None:
        if iteration % self.frequency != 0:
            return
        params = model.params
        weights = (params[self.layer] if isinstance(params, (list, tuple))
                   else params)[self.param]
        if hasattr(weights, "detach"):  # a tensor, possibly on the card
            weights = weights.detach().cpu().numpy()
        weights = np.asarray(weights)
        # filters live in the columns of [n_in, n_out]
        self.filters.set_input(weights.T)
        self.filters.plot()
        render_image(self.filters.get_plot(), self.output_path)
