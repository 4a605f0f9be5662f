"""A/B a trained CV experiment against an inference-only override twin —
counterpart of ``tools/predict_ab.py``.

For every fold of a trained experiment root, re-run inference with the
given config overrides (same checkpoints) on ``--device`` into a sibling
``<root>_<suffix>`` root, evaluate both roots and print the side-by-side
localisation means, then one JSON line of the unrounded means:

    python -m cmrtpu_torch.tools.predict_ab -exp exp/<EXP>/<ts> \\
        -data <root> --set CC_FILTER=3d --suffix cc3d

(--set values are parsed as JSON / Python literals where they can be, so
booleans and numbers work; an unknown key raises.)
"""

import argparse
import os


def main(argv=None) -> dict:
    """Run the A/B; returns the printed JSON's dict (``report_ab``)."""
    parser = argparse.ArgumentParser(
        description="A/B a trained CV root against an inference-override twin")
    parser.add_argument("-exp", required=True,
                        help="trained experiment root (exp/<EXP>/<ts>)")
    parser.add_argument("-data", required=True, help="dataset root")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VAL", required=True,
                        help="inference-only config override (repeatable)")
    parser.add_argument("--suffix", default="ab",
                        help="sibling-root suffix (default 'ab')")
    parser.add_argument("--device", default="cuda",
                        help="device of the twin's inference (default cuda)")
    args = parser.parse_args(argv)

    from cmrtpu_torch import config as C
    from cmrtpu_torch.eval.evaluate import evaluate_cv
    from cmrtpu_torch.predict.predictor import predict_override_twin
    from cmrtpu_torch.tools.columns import report_ab

    overrides = C.parse_override_pairs(args.overrides)
    plain = evaluate_cv(args.exp, args.data)
    t_root = predict_override_twin(args.exp, overrides, args.suffix,
                                   device=args.device)
    twin = evaluate_cv(t_root, args.data)
    return report_ab(
        f"plain vs {overrides} (mean over patient-phases)",
        ("plain", "twin"), (plain, twin),
        (os.path.join(args.exp, "df_eval.csv"),
         os.path.join(t_root, "df_eval.csv")))


if __name__ == "__main__":
    main()
