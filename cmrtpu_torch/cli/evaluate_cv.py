"""CLI: CV evaluation -> df_eval.csv, on the host.

``python -m cmrtpu_torch.cli.evaluate_cv -exp <exp_root> -data <root>``

Counterpart of ``cmrtpu/cli/evaluate_cv.py`` (flag parity with
``python src/models/evaluate_cv.py -exp <exp_root> -data <root>``); writes
``<exp_root>/df_eval.csv``, equal byte for byte to cmrtpu's on the same
tree.
"""

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="evaluate the cv of a rvip detection model")
    parser.add_argument("-exp", action="store", default=None)
    parser.add_argument("-data", action="store", default=None)
    args = parser.parse_args(argv)
    print(f"given parameters: {args}")

    from cmrtpu_torch.eval.evaluate import evaluate_cv
    columns = evaluate_cv(args.exp, args.data)
    print(f"evaluation done for {args.exp}: {len(columns['patient'])} "
          "patient-phase rows -> df_eval.csv")
    return columns


if __name__ == "__main__":
    main()
