"""The training UI (counterpart: ``deeplearning4j_tpu/ui/``): the chart
components with their JSON round trip and the static page
(``components``), the server and its history storage (``server``), and
the listeners that post to it (``listeners``). Rendering happens on the
server as inline SVG, with no script and no network."""

from deeplearning4j_tpu_torch.ui.components import (
    ChartHistogram,
    ChartHorizontalBar,
    ChartLine,
    ChartScatter,
    ChartStackedArea,
    ChartTimeline,
    ComponentTable,
    ComponentImage,
    ComponentText,
    StyleChart,
    component_from_dict,
    render_page,
)
from deeplearning4j_tpu_torch.ui.listeners import (
    ConvolutionalIterationListener,
    FlowIterationListener,
    HistogramIterationListener,
)
from deeplearning4j_tpu_torch.ui.server import HistoryStorage, UiServer

__all__ = [
    "ChartHistogram",
    "ChartHorizontalBar",
    "ChartLine",
    "ChartScatter",
    "ChartStackedArea",
    "ChartTimeline",
    "ComponentTable",
    "ComponentImage",
    "ComponentText",
    "StyleChart",
    "component_from_dict",
    "render_page",
    "HistogramIterationListener",
    "FlowIterationListener",
    "ConvolutionalIterationListener",
    "HistoryStorage",
    "UiServer",
]
