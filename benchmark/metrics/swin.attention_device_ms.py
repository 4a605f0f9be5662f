"""Device time launched under the span ``swin.attention`` (each Swin
block's windowed attention in the forward, models/swin_unet.py) a step,
in ms: the traced sub-window's split by span (``trace["spans"]``), its
``device_total_s`` over the sub-window's steps."""


def read(run):
    t = run.get("trace") or {}
    s = (t.get("spans") or {}).get("swin.attention")
    if not s or not t.get("steps"):
        return None
    return 1e3 * s["device_total_s"] / t["steps"]
