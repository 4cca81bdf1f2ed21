"""QQ and Manhattan plots from result TSVs.

The port's copy of stoat_tpu/plots.py (``plot``).  matplotlib is
imported inside each plotting function, never by ``import
stoat_tpu_torch`` or another command.  Equivalent of the reference's
plot_script/qq_mahanttan_plot.py (which uses pandas+qmplot) in pure
matplotlib/numpy: reads the output TSVs of any mode, takes the mode's
p-value column (P for quantitative/covar/eQTL, P_FISHER or P_CHI2 for
binary), and renders observed-vs-expected -log10(p) and per-chromosome
position scatter.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["read_pvalues", "qq_plot", "manhattan_plot",
           "snarl_boxplots", "histogram_plot", "scatter_plot",
           "report_plots"]


def read_pvalues(tsv_path: str, p_column: Optional[str] = None
                 ) -> Tuple[np.ndarray, List[str], np.ndarray]:
    """Return (p-values, chromosomes, positions) from a results TSV.

    ``p_column`` defaults to "P" if present, else "P_FISHER".
    """
    with open(tsv_path) as fh:
        header = fh.readline().rstrip("\n").lstrip("#").split("\t")
        if p_column is None:
            p_column = "P" if "P" in header else "P_FISHER"
        try:
            p_idx = header.index(p_column)
        except ValueError:
            raise ValueError(f"column {p_column} not in {header}")
        chr_idx = header.index("CHR")
        pos_idx = header.index("START_POS")
        pvals: List[float] = []
        chroms: List[str] = []
        positions: List[int] = []
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if len(cols) <= p_idx:
                continue
            value = cols[p_idx]
            if value == "NA" or value == "":
                continue
            pvals.append(float(value))
            chroms.append(cols[chr_idx])
            positions.append(int(cols[pos_idx]))
    return np.array(pvals), chroms, np.array(positions)


def qq_plot(tsv_path: str, output_png: str,
            p_column: Optional[str] = None, data=None) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p, _, _ = data if data is not None else read_pvalues(tsv_path,
                                                         p_column)
    p = np.clip(np.sort(p), 1e-300, 1.0)
    n = len(p)
    expected = -np.log10((np.arange(n) + 0.5) / n)
    observed = -np.log10(p)[::-1]

    fig, ax = plt.subplots(figsize=(6, 6), facecolor="w", edgecolor="k")
    ax.scatter(sorted(expected), sorted(observed), s=8, alpha=0.7)
    lim = max(expected.max() if n else 1, observed.max() if n else 1)
    ax.plot([0, lim], [0, lim], "r--", lw=1)
    ax.set_xlabel(r"Expected $-log_{10}(P)$")
    ax.set_ylabel(r"Observed $-log_{10}(P)$")
    ax.set_title("QQ plot")
    fig.savefig(output_png, dpi=120)
    plt.close(fig)


def manhattan_plot(tsv_path: str, output_png: str,
                   p_column: Optional[str] = None,
                   sign_threshold: float = 1e-6, data=None) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    p, chroms, positions = (data if data is not None
                            else read_pvalues(tsv_path, p_column))
    p = np.clip(p, 1e-300, 1.0)
    logp = -np.log10(p)

    # vectorized chromosome grouping: the per-row .index()/list scans
    # were O(rows x chroms) — seconds-to-minutes at GWAS scale
    chrom_arr = np.asarray(chroms)
    chrom_order, codes = np.unique(chrom_arr, return_inverse=True)
    offsets_arr = np.zeros(len(chrom_order))
    cum = 0.0
    for ci in range(len(chrom_order)):
        cpos = positions[codes == ci]
        offsets_arr[ci] = cum
        cum += (cpos.max() if len(cpos) else 0) + 1

    x = offsets_arr[codes] + positions
    colors = codes % 2

    fig, ax = plt.subplots(figsize=(12, 4), facecolor="w", edgecolor="k")
    for parity, color in ((0, "#4C72B0"), (1, "#55A868")):
        mask = colors == parity
        ax.scatter(x[mask], logp[mask], s=8, color=color, alpha=0.8)
    significant = p < sign_threshold
    if significant.any():
        ax.scatter(x[significant], logp[significant], s=14, color="r")
    ax.axhline(-np.log10(sign_threshold), color="r", ls="--", lw=1)
    ax.set_xlabel("Chromosome position")
    ax.set_ylabel(r"$-log_{10}(P)$")
    ax.set_title("Manhattan plot")
    fig.savefig(output_png, dpi=120)
    plt.close(fig)


def snarl_boxplots(phenotype_path: str, tables_dir: str,
                   output_dir: str) -> List[str]:
    """Per-snarl genotype/phenotype violin+boxplots.

    Equivalent of the reference's plot_script/box_plox.R: for every
    per-snarl sample×path table dumped by ``-T`` (writer.cpp:181-208),
    classify each sample's genotype from its normalized dosage row —
    a single value ≈1 is homozygous ``path/path``, two values ≈0.5 are
    heterozygous ``pathA/pathB``, anything else is ``Other`` — then plot
    the phenotype distribution per genotype class (counts in the tick
    labels, as in the R script).  Returns the written file paths.
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pheno: dict = {}
    with open(phenotype_path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        iid_col = header.index("IID")
        p_col = header.index("PHENO")
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            try:
                pheno[cols[iid_col]] = float(cols[p_col])
            except (ValueError, IndexError):
                continue

    os.makedirs(output_dir, exist_ok=True)
    written: List[str] = []
    tol = 1e-6
    for name in sorted(os.listdir(tables_dir)):
        table_path = os.path.join(tables_dir, name)
        if not os.path.isfile(table_path):
            continue
        base = os.path.splitext(name)[0]
        with open(table_path) as fh:
            cols = fh.readline().rstrip("\n").split("\t")[1:]
            by_genotype: dict = {}
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                sample = parts[0]
                if sample not in pheno:
                    continue
                values = np.array([float(v) for v in parts[1:]])
                if values.size == 0 or np.all(np.isnan(values)):
                    continue
                order = np.argsort(values)[::-1]
                top1, top2 = values[order[0]], (values[order[1]]
                                                if values.size > 1 else 0.0)
                if abs(top1 - 1.0) < tol:
                    genotype = f"{cols[order[0]]}/{cols[order[0]]}"
                elif abs(top1 - 0.5) < tol and abs(top2 - 0.5) < tol:
                    genotype = f"{cols[order[0]]}/{cols[order[1]]}"
                else:
                    genotype = "Other"
                by_genotype.setdefault(genotype, []).append(pheno[sample])
        if not by_genotype:
            continue
        labels = sorted(by_genotype)
        data = [by_genotype[g] for g in labels]
        ticks = [f"{g.replace('/', chr(10))}\n({len(v)})"
                 for g, v in zip(labels, data)]
        fig, ax = plt.subplots(figsize=(8, 6), facecolor="w")
        ax.violinplot(data, showextrema=False)
        ax.boxplot(data, widths=0.2, flierprops=dict(
            marker="o", markersize=4, markerfacecolor="red"))
        ax.set_xticks(range(1, len(labels) + 1))
        ax.set_xticklabels(ticks)
        ax.set_xlabel("Genotype")
        ax.set_ylabel("Phenotype")
        ax.set_title(f"Boxplot - {base}")
        out_path = os.path.join(output_dir, f"{base}_boxplot.png")
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        written.append(out_path)
    return written


def histogram_plot(tsv_path: str, output_png: str, column: int = 0,
                   bins: int = 50, title: str = "Histogram",
                   x_label: str = "", y_label: str = "Count",
                   log_y: bool = False) -> int:
    """Histogram of one numeric TSV column — the equivalent of
    the reference's tests/scripts/plot_histogram.py (matplotlib bar
    panel over np.histogram; '#' header lines skipped).  Returns the
    number of values plotted."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    values = []
    with open(tsv_path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if column < len(cols):
                try:
                    values.append(float(cols[column]))
                except ValueError:
                    continue
    hist, edges = np.histogram(values, bins=bins)
    fig, ax = plt.subplots(figsize=(12, 10))
    ax.bar(edges[:-1], hist, width=np.diff(edges), align="edge",
           color="#3b6fb6", edgecolor="black", linewidth=0.3)
    if log_y:
        ax.set_yscale("log")
    ax.set_title(title)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    fig.tight_layout()
    fig.savefig(output_png, dpi=150)
    plt.close(fig)
    return len(values)


def scatter_plot(tsv_path: str, output_png: str, x_col: int = 0,
                 y_col: int = 1, color_col: int = -1,
                 title: str = "Scatter", x_label: str = "",
                 y_label: str = "", log_y: bool = False) -> int:
    """Scatter of two TSV columns, optionally colored by a third —
    the equivalent of the reference's tests/scripts/plot_scatter.py
    (gz-aware; '#' header row supplies axis labels when unset)."""
    import gzip

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    opener = gzip.open if tsv_path.endswith("gz") else open
    groups = {}
    with opener(tsv_path, "rt") as fh:
        for line in fh:
            cols = line.rstrip("\n").split("\t")
            if line.startswith("#"):
                if not x_label and x_col < len(cols):
                    x_label = cols[x_col].lstrip("#")
                if not y_label and y_col < len(cols):
                    y_label = cols[y_col]
                continue
            try:
                x = float(cols[x_col])
                y = float(cols[y_col])
            except (ValueError, IndexError):
                continue
            key = cols[color_col] if 0 <= color_col < len(cols) else ""
            groups.setdefault(key, ([], []))
            groups[key][0].append(x)
            groups[key][1].append(y)
    fig, ax = plt.subplots(figsize=(10, 8))
    n = 0
    for key, (xs, ys) in sorted(groups.items()):
        ax.scatter(xs, ys, s=8, alpha=0.7, label=key or None)
        n += len(xs)
    if log_y:
        ax.set_yscale("log")
    if len(groups) > 1:
        ax.legend(fontsize=7, markerscale=2)
    ax.set_title(title)
    ax.set_xlabel(x_label)
    ax.set_ylabel(y_label)
    fig.tight_layout()
    fig.savefig(output_png, dpi=150)
    plt.close(fig)
    return n


def report_plots(results_tsv: str, output_dir: str,
                 p_column: Optional[str] = None) -> List[str]:
    """One-call analysis report — the equivalent of
    tests/scripts/stoat_report_plots.rmd: QQ + Manhattan + a p-value
    histogram from one results TSV, written as PNGs into
    ``output_dir``.  Returns the written paths."""
    import os

    os.makedirs(output_dir, exist_ok=True)
    written = []
    # parse the TSV ONCE for all three plots (it was parsed three times)
    data = read_pvalues(results_tsv, p_column)
    qq = os.path.join(output_dir, "report_qq.png")
    qq_plot(results_tsv, qq, p_column=p_column, data=data)
    written.append(qq)
    man = os.path.join(output_dir, "report_manhattan.png")
    manhattan_plot(results_tsv, man, p_column=p_column, data=data)
    written.append(man)
    pvals = data[0]
    hist = os.path.join(output_dir, "report_pvalue_hist.png")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.hist(pvals, bins=50, color="#3b6fb6", edgecolor="black",
            linewidth=0.3)
    ax.set_title("P-value distribution")
    ax.set_xlabel("p")
    ax.set_ylabel("Count")
    fig.tight_layout()
    fig.savefig(hist, dpi=150)
    plt.close(fig)
    written.append(hist)
    return written
