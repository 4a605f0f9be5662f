"""Mean ``forward_s`` of process_study's record over the window: the
padded bf16 forward and its copy to the host."""


def read(run):
    recs = run.get("records")
    if not recs:
        return None
    return 1e3 * sum(r["forward_s"] for r in recs) / len(recs)
