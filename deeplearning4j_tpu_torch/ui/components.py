"""The server-rendered chart components of the training UI (counterpart:
``deeplearning4j_tpu/ui/components.py``).

``Chart{Line,Scatter,Histogram,StackedArea,HorizontalBar,Timeline}``,
``ComponentTable``, ``ComponentText`` and ``ComponentImage``, each with a
JSON round trip (``to_dict``, ``component_from_dict``), and
``render_page``, the self-contained static page. Each component renders
itself to inline SVG or HTML on the server, so a page needs no script or
network. Colours come from a fixed categorical palette in slot order, and
every chart carries a legend and value tooltips. Host Python: the JAX
package's code with the port's imports, so a render is byte-equal to the
JAX package's for the same inputs.
"""

from __future__ import annotations

import html
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

# Validated categorical palette (fixed slot order — assign, never cycle).
SERIES_COLORS = [
    "#2a78d6", "#eb6834", "#1baf7a", "#eda100",
    "#e87ba4", "#008300", "#4a3aa7", "#e34948",
]
SURFACE = "#fcfcfb"
TEXT_PRIMARY = "#0b0b0b"
TEXT_SECONDARY = "#52514e"
GRID = "#e4e3e0"

_REGISTRY: Dict[str, type] = {}


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


@dataclass
class StyleChart:
    """Reference style/StyleChart.java: width/height/axis strokes."""

    width: int = 640
    height: int = 320
    margin_top: int = 28
    margin_bottom: int = 34
    margin_left: int = 52
    margin_right: int = 16
    stroke_width: float = 2.0

    def to_dict(self):
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


class Component:
    """Reference api/Component.java: typed, JSON-serializable."""

    title: str = ""

    def to_dict(self) -> Dict[str, Any]:
        raise NotImplementedError

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def render(self) -> str:
        """Server-side HTML/SVG."""
        raise NotImplementedError


def component_from_dict(d: Dict[str, Any]) -> Component:
    cls = _REGISTRY[d["component_type"]]
    return cls.from_dict(d)


def _plot_frame(style: StyleChart, title: str, x_min, x_max, y_min, y_max,
                body: str, legend: Sequence[str] = ()) -> str:
    """Shared SVG chrome: title, recessive grid, axis labels, legend."""
    w, h = style.width, style.height
    ml, mr = style.margin_left, style.margin_right
    mt, mb = style.margin_top, style.margin_bottom
    pw, ph = w - ml - mr, h - mt - mb
    grid_lines, labels = [], []
    for i in range(5):
        fy = mt + ph * i / 4
        val = y_max - (y_max - y_min) * i / 4
        grid_lines.append(
            f'<line x1="{ml}" y1="{fy:.1f}" x2="{w - mr}" y2="{fy:.1f}" '
            f'stroke="{GRID}" stroke-width="1"/>'
        )
        labels.append(
            f'<text x="{ml - 6}" y="{fy + 4:.1f}" text-anchor="end" '
            f'font-size="11" fill="{TEXT_SECONDARY}">{val:.3g}</text>'
        )
    for i in range(5):
        fx = ml + pw * i / 4
        val = x_min + (x_max - x_min) * i / 4
        labels.append(
            f'<text x="{fx:.1f}" y="{h - mb + 16}" text-anchor="middle" '
            f'font-size="11" fill="{TEXT_SECONDARY}">{val:.3g}</text>'
        )
    legend_items = []
    if len(legend) >= 2:  # single series: title names it, no legend box
        for i, name in enumerate(legend):
            lx = ml + i * 110
            legend_items.append(
                f'<rect x="{lx}" y="{h - 12}" width="10" height="10" rx="2" '
                f'fill="{SERIES_COLORS[i % len(SERIES_COLORS)]}"/>'
                f'<text x="{lx + 14}" y="{h - 3}" font-size="11" '
                f'fill="{TEXT_PRIMARY}">{html.escape(str(name))}</text>'
            )
    extra_h = 18 if legend_items else 0
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" '
        f'height="{h + extra_h}" style="background:{SURFACE}">'
        f'<text x="{ml}" y="16" font-size="13" font-weight="600" '
        f'fill="{TEXT_PRIMARY}">{html.escape(title)}</text>'
        + "".join(grid_lines) + "".join(labels) + body + "".join(legend_items)
        + "</svg>"
    )


def _scale(v, lo, hi, out_lo, out_hi):
    if hi == lo:
        return (out_lo + out_hi) / 2.0
    return out_lo + (v - lo) * (out_hi - out_lo) / (hi - lo)


@_register
@dataclass
class ChartLine(Component):
    """Reference chart/ChartLine.java: named (x, y) series."""

    title: str = ""
    series: List[Tuple[str, List[float], List[float]]] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)

    def add_series(self, name: str, x: Sequence[float], y: Sequence[float]):
        self.series.append((name, [float(v) for v in x], [float(v) for v in y]))
        return self

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "series": [[n, x, y] for n, x, y in self.series],
            "style": self.style.to_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            title=d["title"],
            series=[(n, x, y) for n, x, y in d["series"]],
            style=StyleChart.from_dict(d["style"]),
        )

    def _bounds(self):
        xs = [v for _, x, _ in self.series for v in x] or [0.0, 1.0]
        ys = [v for _, _, y in self.series for v in y] or [0.0, 1.0]
        return min(xs), max(xs), min(ys), max(ys)

    def render(self) -> str:
        st = self.style
        x0, x1, y0, y1 = self._bounds()
        ml, mt = st.margin_left, st.margin_top
        pw = st.width - ml - st.margin_right
        ph = st.height - mt - st.margin_bottom
        body = []
        for i, (name, xs, ys) in enumerate(self.series):
            pts = " ".join(
                f"{_scale(x, x0, x1, ml, ml + pw):.1f},"
                f"{_scale(y, y0, y1, mt + ph, mt):.1f}"
                for x, y in zip(xs, ys)
            )
            color = SERIES_COLORS[i % len(SERIES_COLORS)]
            body.append(
                f'<polyline points="{pts}" fill="none" stroke="{color}" '
                f'stroke-width="{st.stroke_width}">'
                f"<title>{html.escape(str(name))}</title></polyline>"
            )
        return _plot_frame(st, self.title, x0, x1, y0, y1, "".join(body),
                           [n for n, _, _ in self.series])


@_register
@dataclass
class ChartScatter(ChartLine):
    """Reference chart/ChartScatter.java."""

    def render(self) -> str:
        st = self.style
        x0, x1, y0, y1 = self._bounds()
        ml, mt = st.margin_left, st.margin_top
        pw = st.width - ml - st.margin_right
        ph = st.height - mt - st.margin_bottom
        body = []
        for i, (name, xs, ys) in enumerate(self.series):
            color = SERIES_COLORS[i % len(SERIES_COLORS)]
            for x, y in zip(xs, ys):
                cx = _scale(x, x0, x1, ml, ml + pw)
                cy = _scale(y, y0, y1, mt + ph, mt)
                body.append(
                    f'<circle cx="{cx:.1f}" cy="{cy:.1f}" r="4" fill="{color}" '
                    f'stroke="{SURFACE}" stroke-width="2">'
                    f"<title>{html.escape(str(name))}: ({x:.4g}, {y:.4g})"
                    f"</title></circle>"
                )
        return _plot_frame(st, self.title, x0, x1, y0, y1, "".join(body),
                           [n for n, _, _ in self.series])


@_register
@dataclass
class ChartHistogram(Component):
    """Reference chart/ChartHistogram.java: (lower, upper, count) bins."""

    title: str = ""
    lower: List[float] = field(default_factory=list)
    upper: List[float] = field(default_factory=list)
    counts: List[float] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)

    def add_bin(self, lower: float, upper: float, count: float):
        self.lower.append(float(lower))
        self.upper.append(float(upper))
        self.counts.append(float(count))
        return self

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "lower": self.lower,
            "upper": self.upper,
            "counts": self.counts,
            "style": self.style.to_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(title=d["title"], lower=d["lower"], upper=d["upper"],
                   counts=d["counts"], style=StyleChart.from_dict(d["style"]))

    def render(self) -> str:
        st = self.style
        if not self.counts:
            return _plot_frame(st, self.title, 0, 1, 0, 1, "")
        x0, x1 = min(self.lower), max(self.upper)
        y0, y1 = 0.0, max(self.counts)
        ml, mt = st.margin_left, st.margin_top
        pw = st.width - ml - st.margin_right
        ph = st.height - mt - st.margin_bottom
        body = []
        for lo, hi, c in zip(self.lower, self.upper, self.counts):
            bx0 = _scale(lo, x0, x1, ml, ml + pw)
            bx1 = _scale(hi, x0, x1, ml, ml + pw)
            by = _scale(c, y0, y1, mt + ph, mt)
            # 2px surface gap between adjacent fills; 4px rounded data end
            body.append(
                f'<rect x="{bx0 + 1:.1f}" y="{by:.1f}" '
                f'width="{max(0.5, bx1 - bx0 - 2):.1f}" '
                f'height="{max(0.0, mt + ph - by):.1f}" rx="4" '
                f'fill="{SERIES_COLORS[0]}">'
                f"<title>[{lo:.4g}, {hi:.4g}): {c:.6g}</title></rect>"
            )
        return _plot_frame(st, self.title, x0, x1, y0, y1, "".join(body))


@_register
@dataclass
class ChartStackedArea(ChartLine):
    """Reference chart/ChartStackedArea.java: series stacked bottom-up."""

    def render(self) -> str:
        st = self.style
        if not self.series:
            return _plot_frame(st, self.title, 0, 1, 0, 1, "")
        xs = self.series[0][1]
        acc = [0.0] * len(xs)
        stacks = []
        for name, _, ys in self.series:
            new_acc = [a + y for a, y in zip(acc, ys)]
            stacks.append((name, list(acc), list(new_acc)))
            acc = new_acc
        x0, x1 = min(xs), max(xs)
        y0, y1 = 0.0, max(acc) if acc else 1.0
        ml, mt = st.margin_left, st.margin_top
        pw = st.width - ml - st.margin_right
        ph = st.height - mt - st.margin_bottom
        body = []
        for i, (name, base, top) in enumerate(stacks):
            fwd = [
                f"{_scale(x, x0, x1, ml, ml + pw):.1f},"
                f"{_scale(t, y0, y1, mt + ph, mt):.1f}"
                for x, t in zip(xs, top)
            ]
            back = [
                f"{_scale(x, x0, x1, ml, ml + pw):.1f},"
                f"{_scale(b, y0, y1, mt + ph, mt):.1f}"
                for x, b in reversed(list(zip(xs, base)))
            ]
            color = SERIES_COLORS[i % len(SERIES_COLORS)]
            body.append(
                f'<polygon points="{" ".join(fwd + back)}" fill="{color}" '
                f'fill-opacity="0.85" stroke="{SURFACE}" stroke-width="2">'
                f"<title>{html.escape(str(name))}</title></polygon>"
            )
        return _plot_frame(st, self.title, x0, x1, y0, y1, "".join(body),
                           [n for n, _, _ in self.series])


@_register
@dataclass
class ChartHorizontalBar(Component):
    """Reference chart/ChartHorizontalBar.java: labeled values."""

    title: str = ""
    labels: List[str] = field(default_factory=list)
    values: List[float] = field(default_factory=list)
    style: StyleChart = field(default_factory=StyleChart)

    def add_bar(self, label: str, value: float):
        self.labels.append(label)
        self.values.append(float(value))
        return self

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "labels": self.labels,
            "values": self.values,
            "style": self.style.to_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(title=d["title"], labels=d["labels"], values=d["values"],
                   style=StyleChart.from_dict(d["style"]))

    def render(self) -> str:
        st = self.style
        if not self.values:
            return _plot_frame(st, self.title, 0, 1, 0, 1, "")
        v0, v1 = min(0.0, min(self.values)), max(self.values)
        ml, mt = st.margin_left + 40, st.margin_top
        pw = st.width - ml - st.margin_right
        n = len(self.values)
        bh = max(6.0, (st.height - mt - st.margin_bottom) / max(1, n) - 2)
        body = []
        for i, (lab, v) in enumerate(zip(self.labels, self.values)):
            y = mt + i * (bh + 2)
            x_end = _scale(v, v0, v1, ml, ml + pw)
            body.append(
                f'<rect x="{ml}" y="{y:.1f}" width="{max(0.5, x_end - ml):.1f}" '
                f'height="{bh:.1f}" rx="4" fill="{SERIES_COLORS[0]}">'
                f"<title>{html.escape(str(lab))}: {v:.6g}</title></rect>"
                f'<text x="{ml - 6}" y="{y + bh / 2 + 4:.1f}" text-anchor="end" '
                f'font-size="11" fill="{TEXT_PRIMARY}">'
                f"{html.escape(str(lab))}</text>"
            )
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{st.width}" '
            f'height="{st.height}" style="background:{SURFACE}">'
            f'<text x="{st.margin_left}" y="16" font-size="13" '
            f'font-weight="600" fill="{TEXT_PRIMARY}">'
            f"{html.escape(self.title)}</text>" + "".join(body) + "</svg>"
        )


@_register
@dataclass
class ChartTimeline(Component):
    """Reference chart/ChartTimeline.java: lanes of [start, end, label]."""

    title: str = ""
    lanes: List[Tuple[str, List[Tuple[float, float, str]]]] = field(
        default_factory=list
    )
    style: StyleChart = field(default_factory=StyleChart)

    def add_lane(self, name: str, entries: Sequence[Tuple[float, float, str]]):
        self.lanes.append(
            (name, [(float(a), float(b), str(l)) for a, b, l in entries])
        )
        return self

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "lanes": [[n, [list(e) for e in es]] for n, es in self.lanes],
            "style": self.style.to_dict(),
        }

    @classmethod
    def from_dict(cls, d):
        return cls(
            title=d["title"],
            lanes=[(n, [tuple(e) for e in es]) for n, es in d["lanes"]],
            style=StyleChart.from_dict(d["style"]),
        )

    def render(self) -> str:
        st = self.style
        alls = [e for _, es in self.lanes for e in es]
        if not alls:
            return _plot_frame(st, self.title, 0, 1, 0, 1, "")
        t0 = min(e[0] for e in alls)
        t1 = max(e[1] for e in alls)
        ml, mt = st.margin_left + 30, st.margin_top
        pw = st.width - ml - st.margin_right
        body = []
        lane_h = 24
        for li, (name, entries) in enumerate(self.lanes):
            y = mt + li * (lane_h + 4)
            body.append(
                f'<text x="{ml - 6}" y="{y + 16}" text-anchor="end" '
                f'font-size="11" fill="{TEXT_PRIMARY}">'
                f"{html.escape(str(name))}</text>"
            )
            for si, (a, b, lab) in enumerate(entries):
                xa = _scale(a, t0, t1, ml, ml + pw)
                xb = _scale(b, t0, t1, ml, ml + pw)
                color = SERIES_COLORS[si % len(SERIES_COLORS)]
                body.append(
                    f'<rect x="{xa:.1f}" y="{y}" '
                    f'width="{max(1.0, xb - xa):.1f}" height="{lane_h}" rx="4" '
                    f'fill="{color}" stroke="{SURFACE}" stroke-width="2">'
                    f"<title>{html.escape(lab)}: {a:.6g}-{b:.6g}</title></rect>"
                )
        h = mt + len(self.lanes) * (lane_h + 4) + 8
        return (
            f'<svg xmlns="http://www.w3.org/2000/svg" width="{st.width}" '
            f'height="{h}" style="background:{SURFACE}">'
            f'<text x="{st.margin_left}" y="16" font-size="13" '
            f'font-weight="600" fill="{TEXT_PRIMARY}">'
            f"{html.escape(self.title)}</text>" + "".join(body) + "</svg>"
        )


@_register
@dataclass
class ComponentTable(Component):
    """Reference table/ComponentTable.java."""

    title: str = ""
    header: List[str] = field(default_factory=list)
    rows: List[List[str]] = field(default_factory=list)

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "header": self.header,
            "rows": self.rows,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(title=d["title"], header=d["header"], rows=d["rows"])

    def render(self) -> str:
        head = "".join(f"<th>{html.escape(str(h))}</th>" for h in self.header)
        body = "".join(
            "<tr>" + "".join(f"<td>{html.escape(str(c))}</td>" for c in row)
            + "</tr>"
            for row in self.rows
        )
        return (
            f'<div><h3 style="color:{TEXT_PRIMARY};font-size:13px">'
            f"{html.escape(self.title)}</h3>"
            f'<table style="border-collapse:collapse;font-size:12px;'
            f'color:{TEXT_PRIMARY}"><tr>{head}</tr>{body}</table></div>'
        )


@_register
@dataclass
class ComponentText(Component):
    """Reference text/ComponentText.java."""

    text: str = ""
    title: str = ""

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "text": self.text,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(title=d["title"], text=d["text"])

    def render(self) -> str:
        return (
            f'<p style="color:{TEXT_PRIMARY};font-size:13px">'
            f"{html.escape(self.text)}</p>"
        )


@_register
@dataclass
class ComponentImage(Component):
    """Inline raster image (the PlotFilters/ImageRender display role,
    reference plot/PlotFilters.java + ImageRender.java, rendered into the
    component DSL instead of an AWT window): carries base64 PNG bytes so
    exported pages stay fully self-contained."""

    png_base64: str = ""
    title: str = ""
    scale: int = 1  # integer upscale for small filter tiles (CSS pixels)
    width: int = 0   # source pixel dims (for the <img> size attributes)
    height: int = 0

    @classmethod
    def from_array(cls, image, title: str = "", scale: int = 1):
        """Build from a [H, W] / [H, W, 3/4] array ([0,1] floats or pixel
        values) via plot.filters.image_png_bytes."""
        import base64

        import numpy as np

        from deeplearning4j_tpu_torch.plot.filters import image_png_bytes

        a = np.asarray(image)
        return cls(png_base64=base64.b64encode(
            image_png_bytes(a)).decode("ascii"),
            title=title, scale=scale,
            width=int(a.shape[1]), height=int(a.shape[0]))

    def to_dict(self):
        return {
            "component_type": type(self).__name__,
            "title": self.title,
            "png_base64": self.png_base64,
            "scale": self.scale,
            "width": self.width,
            "height": self.height,
        }

    @classmethod
    def from_dict(cls, d):
        return cls(title=d["title"], png_base64=d["png_base64"],
                   scale=d.get("scale", 1), width=d.get("width", 0),
                   height=d.get("height", 0))

    def render(self) -> str:
        w = self.width * self.scale or ""
        h = self.height * self.scale or ""
        dims = (f' width="{w}" height="{h}"' if w and h else "")
        cap = (f'<div style="color:{TEXT_SECONDARY};font-size:12px">'
               f"{html.escape(self.title)}</div>" if self.title else "")
        return (f'{cap}<img src="data:image/png;base64,{self.png_base64}"'
                f'{dims} style="image-rendering:pixelated;'
                f'border:1px solid {GRID}" '
                f'alt="{html.escape(self.title or "image")}">')


def render_page(components: Sequence[Component], title: str = "DL4J-TPU") -> str:
    """Standalone static page (reference StaticPageUtil/staticpage.ftl) —
    fully self-contained, no external assets."""
    parts = "".join(
        f'<div class="comp">{c.render()}</div>' for c in components
    )
    return f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(title)}</title><style>
body{{font-family:system-ui,sans-serif;background:{SURFACE};margin:1.5em}}
.comp{{display:inline-block;margin:10px;vertical-align:top;
border:1px solid {GRID};border-radius:6px;padding:8px}}
td,th{{border:1px solid {GRID};padding:3px 9px}}
</style></head><body><h2 style="color:{TEXT_PRIMARY}">{html.escape(title)}</h2>
{parts}</body></html>"""
