"""A/B a trained CV experiment against its rot90-TTA twin — counterpart of
``tools/tta_ab.py``: ``predict_ab`` with ``--set TTA=true --set
TTA_MODE=<mode> --suffix tta_<mode>``.

    python -m cmrtpu_torch.tools.tta_ab -exp exp/<EXP>/<ts> -data <root> \\
        --mode coords
"""

import argparse

from cmrtpu_torch.tools import predict_ab


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(
        description="A/B a trained CV experiment against its rot90-TTA twin")
    parser.add_argument("-exp", required=True,
                        help="trained experiment root (exp/<EXP>/<ts>)")
    parser.add_argument("-data", required=True, help="dataset root")
    parser.add_argument("--mode", default="probs", choices=["probs", "coords"],
                        help="probs = orbit-average the sigmoid maps (can "
                             "blur peaks); coords = orbit-average landmark "
                             "coordinates (cmrtpu_torch/predict/tta.py)")
    parser.add_argument("--device", default="cuda",
                        help="device of the twin's inference (default cuda)")
    args = parser.parse_args(argv)
    return predict_ab.main(["-exp", args.exp, "-data", args.data,
                            "--set", "TTA=true",
                            "--set", f"TTA_MODE={args.mode}",
                            "--suffix", f"tta_{args.mode}",
                            "--device", args.device])


if __name__ == "__main__":
    main()
