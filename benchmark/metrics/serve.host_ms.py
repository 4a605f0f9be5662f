"""Mean host time of a study's read and preprocessing over the window:
the ``read_s`` + ``preprocess_s`` of process_study's record."""


def read(run):
    recs = run.get("records")
    if not recs:
        return None
    return 1e3 * sum(r["read_s"] + r["preprocess_s"] for r in recs) / len(recs)
