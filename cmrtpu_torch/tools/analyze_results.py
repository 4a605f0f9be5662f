"""Analysis of a df_eval.csv — counterpart of ``examples/analyze_results.py``
(the script analogue of the reference's Evaluate notebooks, ref:
notebooks/Evaluate/*.ipynb), read without pandas: summary statistics in
the BVM-poster table layout (``summary.csv``) and per pathology, then the
violin panels and Bland-Altman agreement as PNGs next to the csv.

    python -m cmrtpu_torch.tools.analyze_results --df <exp_root>/df_eval.csv

The tables are numpy-only and written first. The figures need
matplotlib; where it is missing (the card's host) the tool warns that they
were skipped.
"""

import argparse
import logging
import os
from typing import Dict, List

from cmrtpu_torch.tools.columns import (mean, numeric, read_columns, sd,
                                        to_float)

METRIC_MAP = (
    ("volume-based |d| anterior (mm)", "mdists_ant_gtpred"),
    ("volume-based |d| inferior (mm)", "mdists_inf_gtpred"),
    ("slice-based |d| anterior (mm)", "mdists_ant_gtpred_slice_wise"),
    ("slice-based |d| inferior (mm)", "mdists_inf_gtpred_slice_wise"),
    ("slice-based + UB |d| anterior (mm)", "mdists_ant_gtpred_slice_wise_up"),
    ("slice-based + UB |d| inferior (mm)", "mdists_inf_gtpred_slice_wise_up"),
    ("TPR (line)", "tpr_ant"),
    ("PPV (line)", "ppv_ant"),
    ("TPR w/ 15mm threshold", "tpr_ant_point_th15"),
    ("PPV w/ 15mm threshold", "ppv_ant_point_th15"),
    ("septum-angle diff (deg)", "mdiffs_gtpred"),
)


def summarise(cols: Dict[str, List]) -> Dict[str, List]:
    """Mean ± SD (ddof 1) and n of each poster metric present, over its
    cells that parse to a number (BASELINE.md layout), as columns
    metric / mean / sd / n."""
    table = {"metric": [], "mean": [], "sd": [], "n": []}
    for label, col in METRIC_MAP:
        if col in cols:
            vals = numeric(cols[col])
            if vals:
                for key, v in (("metric", label), ("mean", mean(vals)),
                               ("sd", sd(vals)), ("n", len(vals))):
                    table[key].append(v)
    return table


def per_pathology(cols: Dict[str, List], col: str) -> Dict[str, Dict]:
    """pathology -> {mean, std (ddof 1), count} of ``col``'s numeric cells,
    pathologies sorted; rows without a pathology are left out (pandas'
    ``groupby(...).agg(["mean", "std", "count"])``)."""
    groups: Dict[str, List] = {}
    for path, v in zip(cols["pathology"], cols[col]):
        if path not in ("", None):
            groups.setdefault(path, []).append(v)
    return {p: {"mean": mean(v), "std": sd(v), "count": len(numeric(v))}
            for p, v in sorted(groups.items())}


def _print_table(table: Dict[str, List]) -> None:
    cells = {"metric": table["metric"],
             "mean": [f"{v:.3f}" for v in table["mean"]],
             "sd": [f"{v:.3f}" for v in table["sd"]],
             "n": [str(v) for v in table["n"]]}
    width = {k: max([len(k)] + [len(c) for c in v]) for k, v in cells.items()}
    print(" ".join(k.rjust(width[k]) for k in cells))
    for i in range(len(table["metric"])):
        print(" ".join(cells[k][i].rjust(width[k]) for k in cells))


def _figures(cols: Dict[str, List], dist_cols: List[str], out: str) -> None:
    from cmrtpu_torch.visualization import analysis as VA

    def floats(names):
        return {c: [to_float(v) for v in cols[c]] for c in names}

    if dist_cols:
        VA.create_eval_plot(floats(dist_cols), eval_name="localisation",
                            names=("|d| mm",),
                            path=os.path.join(out, "violin_distances.png"))
    tpr_cols = [c for c in ("tpr_ant", "tpr_inf", "ppv_ant", "ppv_inf")
                if c in cols]
    if tpr_cols:
        VA.create_eval_plot(floats(tpr_cols), eval_name="detection",
                            names=("TPR / PPV",),
                            path=os.path.join(out, "violin_detection.png"))
    if ("mdists_ant_gtpred" in cols and "mdists_inf_gtpred" in cols
            and numeric(cols["mdists_ant_gtpred"])):
        a, b = ([0.0 if v != v else v for v in floats([c])[c]]
                for c in ("mdists_ant_gtpred", "mdists_inf_gtpred"))
        fig, (md, sd_) = VA.bland_altman_metric_plot(a, b,
                                                      label="|d| ant vs inf")
        fig.savefig(os.path.join(out, "bland_altman.png"), dpi=96)
        VA.pyplot().close(fig)
        print(f"bland-altman: mean diff {md:.3f} ± {1.96 * sd_:.3f}")


def main(argv=None) -> dict:
    """Returns {"summary": columns, "per_pathology": {col: table},
    "figures": bool}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--df", required=True, help="path to df_eval.csv")
    parser.add_argument("--out", default=None, help="figure directory")
    args = parser.parse_args(argv)

    from cmrtpu_torch.eval.evaluate import write_csv

    cols = read_columns(args.df)
    out = args.out or os.path.join(os.path.dirname(os.path.abspath(args.df)),
                                   "figures")
    os.makedirs(out, exist_ok=True)

    table = summarise(cols)
    _print_table(table)
    write_csv(table, os.path.join(out, "summary.csv"))

    dist_cols = [c for c in ("mdists_ant_gtpred", "mdists_inf_gtpred")
                 if c in cols and numeric(cols[c])]
    pathologies = {}
    if "pathology" in cols and any(p for p in cols["pathology"]):
        for col in dist_cols:
            pathologies[col] = per_pathology(cols, col)
            print(f"\nper-pathology {col}:")
            for p, row in pathologies[col].items():
                print(f"  {p:10s} mean {row['mean']:.6f} std "
                      f"{row['std']:.6f} count {row['count']}")

    try:
        from cmrtpu_torch.visualization.visualize import pyplot
        pyplot()
    except ImportError as e:
        logging.warning("analyze_results: matplotlib does not import (%s); "
                        "summary.csv is written, the figures are skipped", e)
        figures = False
    else:
        _figures(cols, dist_cols, out)
        figures = True
    print(f"\nfigures written to {out}" if figures
          else f"\nsummary written to {out}")
    return {"summary": table, "per_pathology": pathologies,
            "figures": figures}


if __name__ == "__main__":
    main()
