"""Recall-vs-QPS curve plots.

Port of ``gbnns_tpu/eval/plot.py``: a static PNG per sweep-results JSON
(``eval.bench.sweep`` output). One axis, thin 2px lines, >=8px markers, a
recessive grid, a legend plus direct end-labels, and categorical series
colors taken in fixed slot order (slots 1-4: blue, orange, aqua, yellow on
a light surface). matplotlib is imported inside the function, so the
package does not need it.
"""

from __future__ import annotations

import json

# Fixed-order categorical slots (slots 5-6 for six-engine comparisons).
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#8553d7", "#c23d5e"]
_INK = "#1a1a19"
_MUTED = "#8a897f"
_GRID = "#e5e4dd"


def plot_sweeps(curves: dict[str, list[dict]], out_png: str, *,
                recall_key: str = "recall_at_10",
                title: str = "Recall vs QPS") -> None:
    """``curves``: label -> list of result dicts (each with qps + recall).
    Higher-right is better; x is log-scale QPS."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(curves) > len(_SERIES):
        raise ValueError(f"at most {len(_SERIES)} series; fold the rest")

    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
    for i, (label, results) in enumerate(curves.items()):
        pts = sorted(((r["qps"], r[recall_key]) for r in results))
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        color = _SERIES[i]
        ax.plot(xs, ys, "-o", color=color, linewidth=1.6, markersize=5.5,
                label=label)
        # direct label at the curve's right end, in ink (text never wears
        # the series color; the mark beside it carries identity)
        ax.annotate(f" {label}", (xs[-1], ys[-1]), color=_INK, fontsize=9,
                    va="center")

    ax.set_xscale("log")
    ax.set_xlabel("QPS (log)", color=_INK)
    ax.set_ylabel(recall_key.replace("_at_", "@"), color=_INK)
    ax.set_title(title, color=_INK, fontsize=11)
    ax.grid(True, which="major", color=_GRID, linewidth=0.7)
    ax.tick_params(colors=_MUTED)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(_GRID)
    if len(curves) >= 2:
        ax.legend(frameon=False, fontsize=9, labelcolor=_INK)
    fig.tight_layout()
    fig.savefig(out_png)
    plt.close(fig)


def plot_results_files(paths: dict[str, str], out_png: str, **kw) -> None:
    """Load sweep JSONs ({label: path}) and plot them together."""
    curves = {}
    for label, p in paths.items():
        with open(p) as f:
            obj = json.load(f)
        curves[label] = obj["results"] if isinstance(obj, dict) else obj
    plot_sweeps(curves, out_png, **kw)
