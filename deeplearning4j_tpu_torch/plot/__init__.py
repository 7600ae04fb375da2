"""Dimensionality reduction and renders of the port (counterpart:
``deeplearning4j_tpu/plot/``): exact t-SNE with its gradient steps on the
device, Barnes-Hut t-SNE on the host over the spatial trees, and the
weight-filter and reconstruction renders."""

from deeplearning4j_tpu_torch.plot.filters import (
    PlotFilters,
    PlotFiltersIterationListener,
    ReconstructionRender,
    reconstruct,
    render_image,
)
from deeplearning4j_tpu_torch.plot.tsne import BarnesHutTsne, Tsne

__all__ = [
    "Tsne", "BarnesHutTsne", "PlotFilters", "PlotFiltersIterationListener",
    "ReconstructionRender", "reconstruct", "render_image",
]
