"""The 90th percentile over the window's requests of the time from when
each was due to the start of the engine step that admitted it (host
stamps), in ms; a request not admitted by the window's close counts the
time to the close."""
from portbench.yardstick import stats


def read(rec):
    w = rec.get("queue_waits_s")
    if not w:
        return None
    return 1e3 * stats.percentile(w, 90)
