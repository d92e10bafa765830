"""Beta diversity: pairwise distance matrices over the sample x k-mer matrix.

The reference computes 20 metrics through skbio's ``beta_diversity`` — which
is a thin wrapper over ``scipy.spatial.distance.pdist``
(/root/reference/lib/mercat2_diversity.py:56-105). We call scipy directly,
write the same per-metric distance TSV + heatmap PNG (when matplotlib is
installed), and keep the reference's per-metric error report (e.g.
mahalanobis fails when samples < dimensions+1, documented in the reference
at line 79).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["BETA_METRICS", "compute_beta_diversity"]

BETA_METRICS = [
    "euclidean",
    "cityblock",
    "braycurtis",
    "canberra",
    "chebyshev",
    "correlation",
    "cosine",
    "dice",
    "hamming",
    "jaccard",
    "mahalanobis",
    "manhattan",  # alias of cityblock (skbio resolves the alias)
    "matching",
    "minkowski",
    "rogerstanimoto",
    "russellrao",
    "seuclidean",
    "sokalmichener",
    "sokalsneath",
    "sqeuclidean",
    "yule",
]

_ALIASES = {
    "manhattan": "cityblock",
    # removed from scipy >= 1.17; scipy's sokalmichener was numerically a
    # duplicate of rogerstanimoto (2R/(S+2R)), NOT of the simple matching
    # distance (R/n)
    "sokalmichener": "rogerstanimoto",
}
#: scipy treats these as boolean vectors; skbio passes the raw counts and
#: scipy casts internally — replicated by bool-casting here for the ones
#: scipy>=1.11 no longer accepts as numeric.
_BOOL_METRICS = {
    "dice",
    "jaccard",
    "matching",
    "rogerstanimoto",
    "russellrao",
    "sokalmichener",
    "sokalsneath",
    "yule",
}


def beta_distance_matrix(metric: str, counts: np.ndarray) -> np.ndarray:
    from scipy.spatial.distance import pdist, squareform

    m = _ALIASES.get(metric, metric)
    x = np.asarray(counts, dtype=np.float64)
    if m in _BOOL_METRICS:
        x = x != 0
    return squareform(pdist(x, metric=m))


def compute_beta_diversity(basename: str, counts_tsv, outpath) -> list[str]:
    """Distance TSV (+ heatmap PNG when matplotlib is installed) per metric;
    returns the metrics that succeeded."""
    outpath = Path(outpath)
    outpath.mkdir(parents=True, exist_ok=True)

    ids: list[str] = []
    counts: list[list[int]] = []
    with open(counts_tsv) as reader:
        reader.readline()
        for line in reader:
            cols = line.rstrip("\n").split("\t")
            ids.append(cols[0])
            counts.append([int(x) for x in cols[1:]])
    mat = np.asarray(counts, dtype=np.int64)

    try:
        import matplotlib  # noqa: F401
        draw = True
    except ImportError:
        draw = False
        print("matplotlib not installed: beta diversity heatmaps skipped, "
              "distance TSVs written")

    # distance computation is cheap; the per-metric PNG render is not
    # (~0.3 s each through matplotlib), so metrics run in a thread pool
    # using the pyplot-free object API (Figure + Agg canvas carries no
    # global state, unlike pyplot). The reference renders its seaborn
    # heatmaps serially inside one Ray task (lib/mercat2_diversity.py:56-105).
    from concurrent.futures import ThreadPoolExecutor

    def one(metric: str) -> str | None:
        try:
            distance = beta_distance_matrix(metric, mat)
        except (ValueError, np.linalg.LinAlgError) as e:
            # the reference logs and continues (lines 101-103), e.g.
            # mahalanobis with fewer samples than dimensions + 1
            print(f"Error with beta metric: {metric.capitalize()}")
            print(e)
            return None
        with open(outpath / f"{metric}-{basename}.tsv", "w") as writer:
            print("", *ids, sep="\t", file=writer)
            for i, row in enumerate(distance):
                print(ids[i], *row, sep="\t", file=writer)
        if draw:
            _heatmap_png(distance, ids, outpath / f"{metric}-{basename}.png")
        return metric

    with ThreadPoolExecutor(max_workers=8) as pool:
        done = [m for m in pool.map(one, BETA_METRICS) if m]
    return done


def _heatmap_png(distance: np.ndarray, ids: list[str], path) -> None:
    from matplotlib.backends.backend_agg import FigureCanvasAgg
    from matplotlib.figure import Figure

    fig = Figure(figsize=(6, 5))
    FigureCanvasAgg(fig)
    ax = fig.add_subplot()
    im = ax.imshow(distance, cmap="viridis")
    ax.set_xticks(range(len(ids)), ids, rotation=45, fontsize=7)
    ax.set_yticks(range(len(ids)), ids, fontsize=7)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
