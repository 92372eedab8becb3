"""End-to-end analysis of a completed experiment's ``run_table.csv``.

Mirrors the reference notebook's flow (SURVEY.md §3.5): load → subset →
IQR outlier removal per metric within the subset (cells 11-13) →
descriptives (cell 15) → H1 Wilcoxon + Cliff's delta per length (cell 37) →
H2 Spearman energy vs the other metrics (cell 42). Emits
``analysis_report.json`` and ``analysis_report.md`` (the notebook emits LaTeX
tables + inline plots; plots here live in ``plots.py``).

Filter-order note: the notebook subsets FIRST and IQR-filters within
each subset (``remove_outliers(filtered_data, METRICS)`` per
method×length subset, cells 11-13). Filtering the pooled table before
subsetting silently discards most big-model long rows as "outliers" of
the pooled distribution (a remote|1000 mean came out 3.8× below the raw
data that way). ``filter_scope`` controls the stratum:

- ``"cell"`` (default) — IQR within each model × location × length cell,
  one level finer than the notebook. This repo's 7 models span ~500× in
  energy (26 J → 13 kJ), so even a location×length subset pools seven
  disjoint distributions and Tukey fences drop whole models; per-cell
  filtering is the same judgement ``variance_check`` already applies and
  preserves every cell's assessability (pinned in tests/test_analysis.py).
- ``"subset"`` — the notebook's exact order (location × length strata),
  for like-for-like comparison with the reference.
- ``"pooled"`` — the pooled filter described above, kept only so the bias is
  reproducible.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

from ..runner.persistence import RunTableStore
from .stats import (
    cliffs_delta,
    descriptives,
    iqr_mask,
    shapiro_wilk,
    significance_stars,
    skewness,
    spearman,
    wilcoxon_rank_sum,
)

# BASELINE.md target: ≤5% run-to-run energy variance per experiment cell.
CV_TARGET = 0.05

DEFAULT_METRICS = (
    "energy_J",
    "execution_time_s",
    "cpu_usage",
    "memory_usage",
    "tokens_per_s",
)
# Every *study-metric* column the framework's profilers/workloads can emit;
# used by ``detect_metrics`` to analyse whatever table it is handed.
# ORDER MATTERS for the energy columns: analyze_experiment picks the first
# populated one as THE energy metric, so measured device channels
# (counter, wall meter, duty-derived) outrank the model — a capstone
# re-run on a measured host analyses real Joules automatically
# (docs/ARCHITECTURE.md measured-host runbook). host_energy_J stays
# below the model: it meters the client CPU, not the serving chips, and
# must never silently become the study metric just because RAPL exists.
KNOWN_METRIC_COLUMNS = (
    "energy_J",
    "gpu_energy_J",
    "wall_energy_J",
    "energy_duty_J",
    "energy_model_J",
    "host_energy_J",
    "sysfs_energy_J",
    "joules_per_token",
    "execution_time_s",
    "prefill_s",
    "decode_s",
    "remote_modeled_decode_s",
    "tokens_per_s",
    "cpu_usage",
    "memory_usage",
    "gpu_util_est",
    "gpu_power_model_W",
    "tpu_duty_cycle_pct",
    "gpu_avg_power_W",
    "host_avg_power_W",
    "sysfs_avg_power_W",
    "wall_avg_power_W",
    # Diagnostic columns the profilers emit (e.g. host_sample_rate_hz) are
    # deliberately NOT listed: they would drag valid rows through the IQR
    # outlier filter and get their own hypothesis tests.
)
LENGTH_LABELS = {100: "short", 500: "medium", 1000: "long"}

# When the energy column is MODEL-derived (energy_model_J), these columns
# are its deterministic inputs or algebraic derivatives — a Spearman ρ
# between them and energy is definitional, not a finding (a report that
# presents ρ(energy, decode_s)=1.000 as a correlation misleads). They are annotated and kept out of the H2 table; H2 runs
# unrestricted only when the energy metric is a measured channel.
MODELLED_ENERGY_DERIVED = (
    "decode_s",  # the model's energy window
    "execution_time_s",  # contains the window
    "remote_modeled_decode_s",  # the window for aliased remote rows
    "joules_per_token",  # energy / tokens
    "gpu_util_est",  # the model's duty-cycle factor
    "gpu_power_model_W",  # the model's own power state (energy / window)
)


def detect_metrics(rows: List[Dict[str, Any]]) -> List[str]:
    """The known metric columns that actually carry data in this table."""
    return [
        m
        for m in KNOWN_METRIC_COLUMNS
        if any(r.get(m) is not None for r in rows)
    ]


def load_rows(experiment_dir: Path) -> List[Dict[str, Any]]:
    return RunTableStore(Path(experiment_dir)).read()


def apply_iqr_filter(
    rows: List[Dict[str, Any]], metrics: Sequence[str], k: float = 1.5
) -> List[Dict[str, Any]]:
    """Drop a row when ANY metric value is an IQR outlier (nb cell 11 applies
    the filter metric-by-metric over the whole table). Rows with a missing
    value for a metric are NOT dropped for that metric — missing ≠ outlier;
    descriptives/tests skip missing values themselves."""
    import numpy as np

    keep = [True] * len(rows)
    for metric in metrics:
        values = [
            row.get(metric) if row.get(metric) is not None else math.nan
            for row in rows
        ]
        arr = np.asarray(values, dtype=float)
        if np.isnan(arr).all():
            continue
        mask = iqr_mask(values, k=k) | np.isnan(arr)
        keep = [k_ and bool(m) for k_, m in zip(keep, mask)]
    return [row for row, k_ in zip(rows, keep) if k_]


def _subset(
    rows: List[Dict[str, Any]], **conditions: Any
) -> List[Dict[str, Any]]:
    return [
        row for row in rows if all(row.get(k) == v for k, v in conditions.items())
    ]


def apply_stratified_iqr_filter(
    rows: List[Dict[str, Any]],
    metrics: Sequence[str],
    strata: Sequence[str],
    k: float = 1.5,
) -> List[Dict[str, Any]]:
    """IQR-filter within each stratum (unique combination of the
    ``strata`` factor levels) independently, preserving the original row
    order. A stratum left with <2 rows keeps its raw rows — a filter that
    can erase a cell wholesale is how a pooled filter publishes a 3.8×-biased
    mean; an outlier judgement needs a surviving distribution to be
    meaningful."""
    by_stratum: Dict[tuple, List[int]] = {}
    for i, row in enumerate(rows):
        by_stratum.setdefault(tuple(row.get(f) for f in strata), []).append(i)
    keep_idx = set()
    for indices in by_stratum.values():
        stratum_rows = [rows[i] for i in indices]
        kept = apply_iqr_filter(stratum_rows, metrics, k=k)
        if len(kept) < 2:
            kept = stratum_rows
        kept_ids = {id(r) for r in kept}
        keep_idx.update(i for i in indices if id(rows[i]) in kept_ids)
    return [row for i, row in enumerate(rows) if i in keep_idx]


def _values(rows: List[Dict[str, Any]], metric: str) -> List[float]:
    return [row[metric] for row in rows if row.get(metric) is not None]


def analyze(
    rows: List[Dict[str, Any]],
    metrics: Sequence[str] = DEFAULT_METRICS,
    location_factor: str = "location",
    length_factor: str = "length",
    model_factor: str = "model",
    energy_metric: str = "energy_J",
    iqr_k: float = 1.5,
    cv_target: float = CV_TARGET,
    filter_scope: str = "cell",
) -> Dict[str, Any]:
    metrics = [m for m in metrics if any(r.get(m) is not None for r in rows)]
    if filter_scope == "pooled":
        filtered = apply_iqr_filter(rows, metrics, k=iqr_k)
    elif filter_scope == "subset":  # the notebook's exact order (cells 11-13)
        filtered = apply_stratified_iqr_filter(
            rows, metrics, (location_factor, length_factor), k=iqr_k
        )
    elif filter_scope == "cell":
        filtered = apply_stratified_iqr_filter(
            rows,
            metrics,
            (model_factor, location_factor, length_factor),
            k=iqr_k,
        )
    else:
        raise ValueError(
            f"filter_scope must be 'cell', 'subset' or 'pooled', "
            f"got {filter_scope!r}"
        )
    locations = sorted({r[location_factor] for r in filtered})
    lengths = sorted({r[length_factor] for r in filtered})

    report: Dict[str, Any] = {
        "n_rows": len(rows),
        "n_after_iqr": len(filtered),
        "filter_scope": filter_scope,
        "metrics": list(metrics),
        "descriptives": {},
        "normality": {},
        "skewness": {},
        "variance_check": {},
        "h1_energy_by_length": {},
        "h1_speed_by_length": {},
        "speed_energy_tradeoff": {},
        "h2_spearman": {},
    }

    for loc in locations:
        for length in lengths:
            sub = _subset(filtered, **{location_factor: loc, length_factor: length})
            key = f"{loc}|{length}"
            report["descriptives"][key] = {
                m: descriptives(_values(sub, m)).as_dict() for m in metrics
            }
            if energy_metric in metrics:
                vals = _values(sub, energy_metric)
                if len(vals) >= 3 and len(set(vals)) > 1:
                    try:
                        w, p = shapiro_wilk(vals)
                        report["normality"][key] = {"W": w, "p": p}
                    except RuntimeError:
                        pass
                    # nb cell 35: skewness decides whether a log transform
                    # is needed; re-check normality on the transformed data
                    # when it is (all energy values are > 0).
                    entry = {"skew": skewness(vals)}
                    if abs(entry["skew"]) > 1 and min(vals) > 0:
                        logged = [math.log(v) for v in vals]
                        entry["skew_log"] = skewness(logged)
                        try:
                            w, p = shapiro_wilk(logged)
                            entry["normality_log"] = {"W": w, "p": p}
                        except RuntimeError:
                            pass
                    report["skewness"][key] = entry

    # Run-to-run variance per experiment cell (model × location × length):
    # BASELINE.md's explicit ≤5% target, assessed as the CV of the energy
    # metric over a cell's repetitions.
    # Judged on the RAW rows with a PER-CELL IQR filter, not the global
    # filter above: that one pools models, so a slow model's entire cell
    # can be dropped wholesale as "outliers" of the pooled subset and
    # become unassessable (6 of 42 cells can go this way) — a
    # within-cell spread measure must be judged against the cell's own
    # distribution. Zero-mean/NaN CVs are flagged, never silently failed.
    if energy_metric in metrics and any(model_factor in r for r in rows):
        models = sorted(
            {str(r.get(model_factor)) for r in rows if model_factor in r}
        )
        # Factor levels enumerated from the RAW rows too: a treatment whose
        # rows the pooled filter drops wholesale (e.g. every remote row of
        # a lopsided sweep) must still get variance entries, not vanish.
        raw_locations = sorted(
            {r[location_factor] for r in rows if location_factor in r}
        )
        raw_lengths = sorted(
            {r[length_factor] for r in rows if length_factor in r}
        )
        cells = {}
        for model in models:
            for loc in raw_locations:
                for length in raw_lengths:
                    sub = _subset(
                        rows,
                        **{
                            model_factor: model,
                            location_factor: loc,
                            length_factor: length,
                        },
                    )
                    vals = _values(sub, energy_metric)
                    if len(vals) < 2:
                        continue
                    kept = [
                        v
                        for v, keep in zip(vals, iqr_mask(vals, k=iqr_k))
                        if keep
                    ]
                    if len(kept) < 2:
                        kept = vals  # degenerate cell; judge it unfiltered
                    d = descriptives(kept)
                    entry: Dict[str, Any] = {"n": d.n, "n_raw": len(vals)}
                    if math.isnan(d.cv):
                        entry.update(
                            cv=None, **{"pass": None},
                            note="zero-mean/NaN CV - unassessable",
                        )
                    else:
                        entry.update(cv=d.cv, **{"pass": bool(d.cv <= cv_target)})
                    cells[f"{model}|{loc}|{length}"] = entry
        assessable = {k: c for k, c in cells.items() if c["cv"] is not None}
        if cells:
            report["variance_check"] = {
                "target_cv": cv_target,
                "metric": energy_metric,
                "cells": cells,
                "n_pass": sum(1 for c in assessable.values() if c["pass"]),
                "n_cells": len(assessable),
                "n_unassessable": len(cells) - len(assessable),
                # three-valued: a table with NO assessable cell has not
                # failed the CV target — it could not be judged at all
                "verdict": (
                    "unassessable"
                    if not assessable
                    else "pass"
                    if all(c["pass"] for c in assessable.values())
                    else "fail"
                ),
            }
            if assessable:
                worst_key = max(assessable, key=lambda k: assessable[k]["cv"])
                report["variance_check"]["worst"] = {
                    "cell": worst_key,
                    **assessable[worst_key],
                }

    # H1 (nb cell 37): on-device vs remote energy per content length.
    if len(locations) == 2 and energy_metric in metrics:
        loc_a, loc_b = locations
        for length in lengths:
            a = _values(
                _subset(filtered, **{location_factor: loc_a, length_factor: length}),
                energy_metric,
            )
            b = _values(
                _subset(filtered, **{location_factor: loc_b, length_factor: length}),
                energy_metric,
            )
            if not a or not b:
                continue
            try:
                u, p = wilcoxon_rank_sum(a, b)
            except RuntimeError:
                u, p = math.nan, math.nan
            delta, magnitude = cliffs_delta(a, b)
            mean_a = sum(a) / len(a)
            mean_b = sum(b) / len(b)
            report["h1_energy_by_length"][str(length)] = {
                "label": LENGTH_LABELS.get(length, str(length)),
                "compare": f"{loc_a} vs {loc_b}",
                "U": u,
                "p": p,
                "stars": significance_stars(p),
                "cliffs_delta": delta,
                "magnitude": magnitude,
                "mean_ratio": mean_a / mean_b if mean_b else math.nan,
            }

    # H1-speed: the reference's research
    # question is a JOINT speed-vs-energy trade-off — its headline speed
    # result is measured exec time 8.9 s remote vs 15.1 s on-device
    # (BASELINE.md:27-32, nb cell 37 runs the same tests on
    # execution_time) — so the published analysis must tabulate the speed
    # axis next to the energy axis, not leave it in a README footnote.
    # The serving-side decode window per row: remote rows measured on an
    # aliased single chip carry the TP-roofline MODELLED mesh window
    # (remote_modeled_decode_s); genuine remote rows and all on-device
    # rows use the measured decode_s. Provenance (how many remote values
    # are modelled) is recorded and rendered so a modelled comparison can
    # never read as a measured one.
    if len(locations) == 2 and "decode_s" in metrics:
        loc_a, loc_b = locations

        def _serving_decode(row: Dict[str, Any]) -> "tuple[Any, bool]":
            # remote_modeled_decode_s is populated only on rows whose
            # serving mesh was aliased onto a measured single chip
            # (generation_stats_from) — whatever the treatment's label,
            # its presence means the honest serving window is the
            # modelled one. Keying on the column, not on a literal
            # "remote" level, keeps a differently-labelled arm from
            # publishing its aliased single-chip time as "measured".
            modeled = row.get("remote_modeled_decode_s")
            if modeled is not None:
                return modeled, True
            return row.get("decode_s"), False

        for length in lengths:
            pairs_a = [
                _serving_decode(r)
                for r in _subset(
                    filtered, **{location_factor: loc_a, length_factor: length}
                )
            ]
            pairs_b = [
                _serving_decode(r)
                for r in _subset(
                    filtered, **{location_factor: loc_b, length_factor: length}
                )
            ]
            a = [v for v, _ in pairs_a if v is not None]
            b = [v for v, _ in pairs_b if v is not None]
            if not a or not b:
                continue
            n_modelled = sum(m for _, m in pairs_a) + sum(
                m for _, m in pairs_b
            )
            try:
                u, p = wilcoxon_rank_sum(a, b)
            except RuntimeError:
                u, p = math.nan, math.nan
            delta, magnitude = cliffs_delta(a, b)
            mean_a = sum(a) / len(a)
            mean_b = sum(b) / len(b)
            # provenance denominator: the arm(s) carrying modelled
            # windows; when none do, the comparison is fully measured
            n_arm = (
                (len(pairs_a) if any(m for _, m in pairs_a) else 0)
                + (len(pairs_b) if any(m for _, m in pairs_b) else 0)
            )
            report["h1_speed_by_length"][str(length)] = {
                "label": LENGTH_LABELS.get(length, str(length)),
                "compare": f"{loc_a} vs {loc_b}",
                "metric": "serving decode window (s)",
                "U": u,
                "p": p,
                "stars": significance_stars(p),
                "cliffs_delta": delta,
                "magnitude": magnitude,
                # >1 ⇒ loc_b decodes faster
                "mean_ratio": mean_a / mean_b if mean_b else math.nan,
                "n_modelled": int(n_modelled),
                "n_remote": n_arm,
                "remote_provenance": (
                    "measured"
                    if n_modelled == 0
                    else "modelled (TP roofline)"
                    if n_modelled == n_arm
                    else "mixed measured/modelled"
                ),
            }

    # The joint statement the two H1 tables imply — the reference's
    # actual research question (experiment/RunnerConfig.py:122-131): how
    # much faster is remote, and at what energy multiple. Stated per
    # length and as a range, with the provenance of each axis carried
    # along (the energy axis is the energy model; the speed axis's remote
    # side is roofline-modelled on aliased capstone topologies). Gated on
    # the study's canonical labels: the block's keys name "remote"
    # directionally (loc_b = the sorted-second level), which only means
    # what it says for the on_device/remote pair — a custom two-level
    # location factor still gets the generic H1-speed table above.
    if (
        report["h1_energy_by_length"]
        and report["h1_speed_by_length"]
        and locations == ["on_device", "remote"]
    ):
        per_length = {}
        for length, h_speed in report["h1_speed_by_length"].items():
            h_energy = report["h1_energy_by_length"].get(length)
            if h_energy is None:
                continue
            speedup = h_speed["mean_ratio"]  # on_device / remote time
            energy_mult = (
                1.0 / h_energy["mean_ratio"]
                if h_energy["mean_ratio"]
                else math.nan
            )  # remote J / on_device J
            per_length[length] = {
                "label": h_speed["label"],
                "remote_speedup": speedup,
                "remote_energy_multiple": energy_mult,
            }
        if per_length:
            speedups = [
                v["remote_speedup"]
                for v in per_length.values()
                if not math.isnan(v["remote_speedup"])
            ]
            mults = [
                v["remote_energy_multiple"]
                for v in per_length.values()
                if not math.isnan(v["remote_energy_multiple"])
            ]
            report["speed_energy_tradeoff"] = {
                "per_length": per_length,
                "speedup_range": [min(speedups), max(speedups)]
                if speedups
                else None,
                "energy_multiple_range": [min(mults), max(mults)]
                if mults
                else None,
                "speed_provenance": sorted(
                    {
                        h["remote_provenance"]
                        for h in report["h1_speed_by_length"].values()
                    }
                ),
                "energy_provenance": (
                    "modelled (energy_model_J)"
                    if energy_metric == "energy_model_J"
                    else f"measured ({energy_metric})"
                ),
            }

    # H2 (nb cell 42): what correlates with energy, per location. When the
    # energy column is MODELLED, its deterministic inputs/derivatives are
    # annotated as definitional and reported separately — ρ=1.000 between
    # a model and its own input is arithmetic, not evidence. Measured
    # energy channels (energy_J, gpu_energy_J, ...) run unrestricted.
    if energy_metric in metrics:
        modelled = energy_metric == "energy_model_J"
        report["h2_energy_is_modelled"] = modelled
        for loc in locations:
            sub = _subset(filtered, **{location_factor: loc})
            energy = [r.get(energy_metric) for r in sub]
            report["h2_spearman"][loc] = {}
            for m in metrics:
                if m == energy_metric:
                    continue
                other = [r.get(m) for r in sub]
                rho, p = spearman(energy, other)
                entry = {
                    "rho": rho,
                    "p": p,
                    "stars": significance_stars(p),
                }
                if modelled and m in MODELLED_ENERGY_DERIVED:
                    entry["definitional"] = True
                report["h2_spearman"][loc][m] = entry
    return report


def _fmt_stat(metric: str, v: float) -> str:
    """gpu_util_est renders as a percentage at 2 significant figures —
    the column mirrors the reference's GPU-residency metric
    (RunnerConfig.py:207-226) and "0.00" hides a real 61% duty."""
    if metric == "gpu_util_est":
        pct = v * 100
        # ".2g" flips to scientific notation at 100 ("1e+02%") — a
        # saturated cell (util capped at 1.0) must read "100%"
        return f"{pct:.0f}%" if pct >= 99.5 else f"{pct:.2g}%"
    return f"{v:.2f}"


def render_markdown(report: Dict[str, Any]) -> str:
    lines = ["# Experiment analysis", ""]
    scope = report.get("filter_scope", "pooled")
    lines.append(
        f"Rows: {report['n_rows']} → {report['n_after_iqr']} after IQR "
        f"filtering (scope: per-{scope} strata)."
        + (
            " The reference notebook's exact filter order is scope "
            "`subset` (location×length, nb cells 11-13); re-run with "
            "`--filter-scope subset` for like-for-like numbers."
            if scope != "subset"
            else ""
        )
    )
    lines.append("")
    lines.append("## Descriptives (mean / median / SD)")
    lines.append("")
    lines.append("| subset | " + " | ".join(report["metrics"]) + " |")
    lines.append("|" + "---|" * (len(report["metrics"]) + 1))
    for key, per_metric in sorted(report["descriptives"].items()):
        cells = []
        for m in report["metrics"]:
            d = per_metric[m]
            if d["n"] == 0 or math.isnan(d["mean"]):
                cells.append("—")
            else:
                cells.append(
                    f"{_fmt_stat(m, d['mean'])} / {_fmt_stat(m, d['median'])}"
                    f" / {_fmt_stat(m, d['sd'])}"
                )
        lines.append(f"| {key} | " + " | ".join(cells) + " |")
    if report["h1_energy_by_length"]:
        lines += ["", "## H1: energy, on-device vs remote", ""]
        lines.append("| length | U | p | Cliff's δ | magnitude | mean ratio |")
        lines.append("|---|---|---|---|---|---|")
        for length, h in sorted(report["h1_energy_by_length"].items()):
            lines.append(
                f"| {h['label']} | {h['U']:.1f} | {h['p']:.2e}{h['stars']} "
                f"| {h['cliffs_delta']:.3f} | {h['magnitude']} "
                f"| {h['mean_ratio']:.2f}× |"
            )
    if report.get("h1_speed_by_length"):
        lines += ["", "## H1-speed: serving decode time, on-device vs remote", ""]
        provs = sorted(
            {h["remote_provenance"] for h in report["h1_speed_by_length"].values()}
        )
        if provs == ["measured"]:
            lines.append(
                "Both sides of this comparison are **measured** decode "
                "windows."
            )
        else:
            lines.append(
                "Provenance: the on-device side is the **measured** decode "
                "window; the remote side is the TP-roofline **modelled** "
                "mesh window (`remote_modeled_decode_s`) for rows measured "
                "on an aliased single chip (see the run table's `backend` "
                "column and docs/sample_run/README.md) — this table states "
                "what the mesh model predicts, not a measurement."
            )
        lines.append("")
        lines.append(
            "| length | U | p | Cliff's δ | magnitude | remote speedup "
            "| remote side |"
        )
        lines.append("|---|---|---|---|---|---|---|")
        for length, h in sorted(report["h1_speed_by_length"].items()):
            lines.append(
                f"| {h['label']} | {h['U']:.1f} | {h['p']:.2e}{h['stars']} "
                f"| {h['cliffs_delta']:.3f} | {h['magnitude']} "
                f"| {h['mean_ratio']:.2f}× "
                f"| {h['remote_provenance']} ({h['n_modelled']}/"
                f"{h['n_remote']} modelled) |"
            )
    if report.get("speed_energy_tradeoff"):
        t = report["speed_energy_tradeoff"]
        lines += ["", "## Speed–energy trade-off (the study's joint result)", ""]
        if t.get("speedup_range") and t.get("energy_multiple_range"):
            s_lo, s_hi = t["speedup_range"]
            e_lo, e_hi = t["energy_multiple_range"]
            lines.append(
                f"**Remote serving decodes "
                f"{s_lo:.1f}–{s_hi:.1f}× faster at "
                f"{e_lo:.2f}–{e_hi:.2f}× the Joules of on-device serving** "
                f"(ranges across content lengths). Speed axis: "
                f"{', '.join(t['speed_provenance'])}; energy axis: "
                f"{t['energy_provenance']}."
            )
            lines.append("")
        lines.append("| length | remote speedup | remote energy multiple |")
        lines.append("|---|---|---|")
        for length, v in sorted(t.get("per_length", {}).items()):
            lines.append(
                f"| {v['label']} | {v['remote_speedup']:.2f}× "
                f"| {v['remote_energy_multiple']:.2f}× |"
            )
    if report.get("variance_check"):
        vc = report["variance_check"]
        lines += ["", "## Run-to-run variance (≤{:.0%} CV target)".format(
            vc["target_cv"]
        ), ""]
        headline = (
            f"**{vc['verdict'].upper()}** — {vc['n_pass']}/{vc['n_cells']} "
            f"cells within target on `{vc['metric']}`"
        )
        if vc.get("worst"):
            headline += (
                f"; worst cell `{vc['worst']['cell']}` at CV "
                f"{vc['worst']['cv']:.3f} (n={vc['worst']['n']})"
            )
        if vc.get("n_unassessable"):
            headline += f"; {vc['n_unassessable']} cell(s) unassessable (NaN CV)"
        lines.append(headline + ".")
        lines += ["", "| cell | n | CV | ≤ target |", "|---|---|---|---|"]
        for cell, c in sorted(vc["cells"].items()):
            if c["cv"] is None:
                lines.append(f"| {cell} | {c['n']} | — | unassessable |")
            else:
                lines.append(
                    f"| {cell} | {c['n']} | {c['cv']:.4f} "
                    f"| {'yes' if c['pass'] else 'NO'} |"
                )
    if report.get("skewness"):
        lines += ["", "## Skewness (log-transform check)", ""]
        lines.append("| subset | skew | skew(log) | Shapiro p (log) |")
        lines.append("|---|---|---|---|")
        for key, s in sorted(report["skewness"].items()):
            skew_log = (
                f"{s['skew_log']:.3f}" if "skew_log" in s else "—"
            )
            p_log = (
                f"{s['normality_log']['p']:.2e}"
                if "normality_log" in s
                else "—"
            )
            lines.append(f"| {key} | {s['skew']:.3f} | {skew_log} | {p_log} |")
    if report["h2_spearman"]:
        lines += ["", "## H2: Spearman correlations with energy", ""]
        if report.get("h2_energy_is_modelled"):
            lines.append(
                "The energy column is MODEL-derived (`energy_model_J`); "
                "columns that are inputs or algebraic derivatives of the "
                "model are listed separately below each table as "
                "*definitional* — their ρ is arithmetic, not evidence. "
                "Re-run on a measured channel (RAPL / power counter / "
                "duty cycle) for an unrestricted H2."
            )
            lines.append("")
        for loc, per_metric in sorted(report["h2_spearman"].items()):
            lines.append(f"### {loc}")
            lines.append("")
            lines.append("| metric | ρ | p |")
            lines.append("|---|---|---|")
            definitional = []
            for m, h in per_metric.items():
                rho = "—" if math.isnan(h["rho"]) else f"{h['rho']:.3f}"
                p = "—" if math.isnan(h["p"]) else f"{h['p']:.2e}{h['stars']}"
                if h.get("definitional"):
                    definitional.append(f"{m} (ρ={rho})")
                    continue
                lines.append(f"| {m} | {rho} | {p} |")
            if definitional:
                lines.append("")
                lines.append(
                    "Definitional (excluded from the table): "
                    + ", ".join(definitional)
                    + "."
                )
            lines.append("")
    return "\n".join(lines) + "\n"


def render_latex_descriptives(
    report: Dict[str, Any], metric: str
) -> str:
    """The notebook's cell-15 deliverable: a LaTeX tabular of
    mean/median/SD per location × length subset for one metric (the paper
    pastes this into the manuscript)."""
    lines = [
        "\\begin{tabular}{lrrrr}",
        "\\hline",
        "subset & n & mean & median & SD \\\\",
        "\\hline",
    ]
    for key, per_metric in sorted(report["descriptives"].items()):
        d = per_metric.get(metric)
        if not d or d["n"] == 0 or math.isnan(d["mean"]):
            continue
        # escape LaTeX specials in factor levels ('on_device' would abort
        # compilation as a math-mode subscript outside math mode)
        subset = (
            key.replace("|", " / ")
            .replace("_", "\\_")
            .replace("%", "\\%")
            .replace("&", "\\&")
            .replace("#", "\\#")
        )
        lines.append(
            f"{subset} & {d['n']} & {d['mean']:.2f} & {d['median']:.2f} "
            f"& {d['sd']:.2f} \\\\"
        )
    lines += ["\\hline", "\\end{tabular}"]
    return "\n".join(lines) + "\n"


def analyze_experiment(
    experiment_dir: Path,
    out_dir: Optional[Path] = None,
    metrics: Optional[Sequence[str]] = None,
    energy_metric: Optional[str] = None,
    make_plots: bool = False,
    filter_scope: str = "cell",
) -> Dict[str, Any]:
    """Load, analyze, and write ``analysis_report.{json,md}`` (+plots).

    ``metrics=None`` auto-detects the populated metric columns from the
    table (single parse — callers should not pre-load for detection).
    """
    experiment_dir = Path(experiment_dir)
    out_dir = Path(out_dir) if out_dir else experiment_dir
    rows = load_rows(experiment_dir)
    if metrics is None:
        metrics = detect_metrics(rows)
    if energy_metric is None:
        energy_metric = next(
            (m for m in metrics if "energy" in m), DEFAULT_METRICS[0]
        )
    report = analyze(
        rows,
        metrics=metrics,
        energy_metric=energy_metric,
        filter_scope=filter_scope,
    )
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "analysis_report.json").write_text(json.dumps(report, indent=2))
    (out_dir / "analysis_report.md").write_text(render_markdown(report))
    # nb cell 15 parity: the paper's LaTeX descriptives table
    (out_dir / "descriptives.tex").write_text(
        render_latex_descriptives(report, energy_metric)
    )
    if make_plots:
        from .plots import plot_experiment

        plot_experiment(rows, out_dir, metrics=metrics)
    return report
