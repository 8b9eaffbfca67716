"""Manhattan and QQ plots for association results.

API parity with the reference plotting layer (reference plotting/plot.py:15
``manhattan_plot`` and :276 ``qq_plot``), re-implemented on matplotlib with
the same cutoff semantics: Bonferroni, genome-wide 5e-8, or a fixed
-log10 threshold (reference plotting/plot.py:87-104).  The reference's
optional plotly interactive path is gated behind ``interactive=True``.
matplotlib is imported only when a plot is drawn, so the package imports
without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def available() -> bool:
    """Whether matplotlib is installed, i.e. whether plots can be drawn."""
    import importlib.util

    return importlib.util.find_spec("matplotlib") is not None


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def manhattan_plot(
    df,
    pval_col: str = "p_wald",
    chrom_col: str = "chrom",
    pos_col: str = "pos",
    cutoff: str | float = "bonferroni",
    save_path: Optional[str] = None,
    title: Optional[str] = None,
    interactive: bool = False,
    ax=None,
    scale: str = "log",
    cmap=None,
    use_seaborn: bool = False,
):
    """Manhattan plot; ``df`` is the association DataFrame.

    cutoff: "bonferroni" (0.05/p), "gw" (5e-8) or a fixed -log10 value
    (reference plotting/plot.py:87-104).
    scale: "log" plots -log10(p); "linear" plots raw p with the cutoff
    left on the p scale (reference plotting/plot.py:20,:49-52).
    cmap: per-chromosome color cycle -- a list of colors or a named
    matplotlib colormap; None keeps the default two-tone cycle
    (reference plotting/plot.py:22 used the seaborn palette).
    use_seaborn: apply seaborn's default style/palette when seaborn is
    installed (reference styled every plot through sns.scatterplot).
    """
    p = np.asarray(df[pval_col], dtype=float)
    m = np.isfinite(p) & (p > 0)
    logp = np.full(p.shape, np.nan)
    if scale == "log":
        logp[m] = -np.log10(p[m])
    elif scale in ("linear", None):
        logp[m] = p[m]
    else:
        raise ValueError(f"invalid scale {scale!r} (use 'log' or 'linear')")

    if chrom_col in getattr(df, "columns", []):
        chrom = np.asarray(df[chrom_col])
        pos = (
            np.asarray(df[pos_col], dtype=float)
            if pos_col in df.columns
            else np.arange(len(p), dtype=float)
        )
    else:
        chrom = np.ones(len(p), dtype=int)
        pos = np.arange(len(p), dtype=float)

    if cutoff == "bonferroni":
        alpha = 0.05 / max(m.sum(), 1)
    elif cutoff == "gw":
        alpha = 5e-8
    else:
        # a number is a -log10 threshold on the log scale (back-compat) and
        # a raw p cutoff on the linear scale
        alpha = 10.0 ** (-float(cutoff)) if scale == "log" else float(cutoff)
    thr = -np.log10(alpha) if scale == "log" else alpha

    if interactive:
        beta = (np.asarray(df["beta"], float)
                if "beta" in getattr(df, "columns", []) else None)
        snp_names = (np.asarray(df["SNPs"]).astype(str)
                     if "SNPs" in getattr(df, "columns", []) else None)
        return _manhattan_plotly(chrom, pos, logp, thr, save_path, title,
                                 beta=beta, snp_names=snp_names)

    plt = _mpl()
    if use_seaborn:
        try:
            import seaborn as sns

            sns.set_theme()
            if cmap is None:
                cmap = list(sns.color_palette())
        except ImportError:
            pass
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(12, 4))
    offset = 0.0
    uniq = list(dict.fromkeys(chrom.tolist()))
    if cmap is None:
        colors = ["#4C72B0", "#55A868"]
    elif isinstance(cmap, str):
        cm = plt.get_cmap(cmap)
        colors = [cm(i / max(len(uniq) - 1, 1)) for i in range(len(uniq))]
    else:
        colors = list(cmap)
    for i, ch in enumerate(uniq):
        sel = chrom == ch
        order = np.argsort(pos[sel])
        xs = offset + np.arange(sel.sum(), dtype=float)
        ax.scatter(xs, logp[sel][order], s=4,
                   c=[colors[i % len(colors)]], rasterized=True)
        offset += sel.sum()
    ax.axhline(thr, color="red", ls="--", lw=1)
    ax.set_xlabel("position")
    ax.set_ylabel(r"$-\log_{10}(p)$" if scale == "log" else r"$p$")
    if title:
        ax.set_title(title)
    if save_path and own_fig:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return ax


def _manhattan_plotly(chrom, pos, logp, thr, save_path, title,
                      beta=None, snp_names=None):
    """Interactive Manhattan (reference plotting/plot.py:106-237 semantics):

    * one colored trace per chromosome; the dense background layer carries
      no hover payload (hoverinfo='skip') so the HTML stays light,
    * a second per-chromosome layer for SNPs above the cutoff with rich
      hover text (chrom:pos, SNP id, beta, -log10 p),
    * chromosome labels as x ticks at each chromosome's median index,
    * dashed cutoff line; ``write_html`` with MathJax for the axis label.
    """
    try:
        import plotly.graph_objects as go
        import plotly.express as px
    except Exception as e:  # pragma: no cover
        raise ImportError("plotly not available for interactive plots") from e

    palette = px.colors.qualitative.Plotly
    order = np.lexsort((pos, chrom))
    chrom_s, logp_s = chrom[order], logp[order]
    pos_s = pos[order]
    beta_s = beta[order] if beta is not None else None
    names_s = snp_names[order] if snp_names is not None else None
    idx = np.arange(len(logp_s))

    fig = go.Figure()
    tickvals, ticktext = [], []
    for ci, ch in enumerate(dict.fromkeys(chrom_s.tolist())):
        sel = chrom_s == ch
        color = palette[ci % len(palette)]
        tickvals.append(float(np.median(idx[sel])))
        ticktext.append(str(ch))
        fig.add_trace(go.Scattergl(
            x=idx[sel], y=logp_s[sel], mode="markers",
            marker=dict(size=3, color=color, line=dict(width=0)),
            hoverinfo="skip", showlegend=False,
        ))
        sig = sel & (logp_s >= thr)
        if not sig.any():
            continue
        hover = [
            f"{chrom_s[i]}:{pos_s[i]:g}"
            + (f"<br>{names_s[i]}" if names_s is not None else "")
            + (f"<br>beta: {beta_s[i]:.2e}" if beta_s is not None else "")
            + f"<br>-log10(p): {logp_s[i]:.2f}"
            for i in idx[sig]
        ]
        fig.add_trace(go.Scattergl(
            x=idx[sig], y=logp_s[sig], mode="markers",
            marker=dict(size=6, color=color, line=dict(width=0)),
            hoverinfo="text", hovertext=hover, showlegend=False,
        ))

    fig.add_hline(y=thr, line_dash="dash", line_color="red")
    fig.update_layout(
        xaxis_title="Chromosome",
        xaxis=dict(tickmode="array", tickvals=tickvals, ticktext=ticktext),
        yaxis_title=r"$-\log_{10}(p)$",
        showlegend=False,
        title=title or "Manhattan Plot",
    )
    if save_path:
        fig.write_html(save_path, include_mathjax="cdn")
    return fig


def qq_plot(pvals: Sequence[float], save_path: Optional[str] = None,
            title: Optional[str] = None, ax=None):
    """QQ plot of observed vs expected -log10 p under uniformity
    (reference plotting/plot.py:276-342)."""
    p = np.asarray(pvals, dtype=float)
    p = p[np.isfinite(p) & (p > 0)]
    n = len(p)
    obs = -np.log10(np.sort(p))
    exp = -np.log10((np.arange(1, n + 1) - 0.5) / n)

    plt = _mpl()
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(exp, obs, s=5, rasterized=True)
    lim = max(exp.max() if n else 1.0, obs.max() if n else 1.0)
    ax.plot([0, lim], [0, lim], "r--", lw=1)
    ax.set_xlabel(r"expected $-\log_{10}(p)$")
    ax.set_ylabel(r"observed $-\log_{10}(p)$")
    if title:
        ax.set_title(title)
    if save_path and own_fig:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return ax
