"""A/B a trained CV experiment against its uniform model soup —
counterpart of ``tools/soup_ab.py``.

The fold ensemble pays one forward per member; the soup (the fold
checkpoints averaged into one model, ``predict/ensemble.py:
soup_experiment``) pays one. This tool writes the soup root (each fold's
test split predicted on ``--device``), evaluates both roots and prints the
side-by-side localisation means, then one JSON line of the unrounded
means. A root of int8 twins raises, as ``soup_experiment`` does:

    python -m cmrtpu_torch.tools.soup_ab -exp exp/<EXP>/<ts> -data <root>
"""

import argparse
import os


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="A/B a trained CV root against its uniform model soup")
    parser.add_argument("-exp", required=True,
                        help="trained experiment root (exp/<EXP>/<ts>)")
    parser.add_argument("-data", required=True, help="dataset root")
    parser.add_argument("--device", default="cuda",
                        help="device of the soup's inference (default cuda)")
    args = parser.parse_args(argv)

    from cmrtpu_torch.eval.evaluate import evaluate_cv
    from cmrtpu_torch.predict.ensemble import soup_experiment
    from cmrtpu_torch.tools.columns import report_ab

    plain = evaluate_cv(args.exp, args.data)
    soup_root = soup_experiment(args.exp, device=args.device)
    soup = evaluate_cv(soup_root, args.data)
    return report_ab(
        "per-fold CV vs uniform soup (mean over patient-phases)",
        ("cv", "soup"), (plain, soup),
        (os.path.join(args.exp, "df_eval.csv"),
         os.path.join(soup_root, "df_eval.csv")))


if __name__ == "__main__":
    main()
