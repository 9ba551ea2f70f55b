"""Rows decoded for a live request over the rows the decode steps ran
(steps times slots), from the engine's counters over the window, in %."""


def read(rec):
    c = rec.get("counters")
    if not c or not c["decode_steps"]:
        return None
    return 100.0 * c["decode_tokens"] / (c["decode_steps"] * rec["slots"])
