"""Statistical analysis pipeline.

Python reimplementation of the reference's R notebook
(``data-analysis/analysis-visualization.ipynb``, 46 cells — SURVEY.md §3.5):
IQR outlier removal, descriptives, normality checks, Wilcoxon rank-sum with
Cliff's delta effect sizes (H1: on-device vs remote energy), Spearman
correlations (H2: what correlates with energy), and the violin/QQ/scatter
plots. Runs headless over ``run_table.csv`` and emits JSON + markdown instead
of notebook cells.
"""

from .stats import (
    cliffs_delta,
    descriptives,
    iqr_mask,
    shapiro_wilk,
    spearman,
    wilcoxon_rank_sum,
)

__all__ = [
    "cliffs_delta",
    "descriptives",
    "iqr_mask",
    "shapiro_wilk",
    "spearman",
    "wilcoxon_rank_sum",
]
