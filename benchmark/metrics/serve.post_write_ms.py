"""Mean ``post_write_s`` of process_study's record over the window: the
threshold, the CC filter (K2) with its copy back, the inverse steps and
the NRRD write."""


def read(run):
    recs = run.get("records")
    if not recs:
        return None
    return 1e3 * sum(r["post_write_s"] for r in recs) / len(recs)
