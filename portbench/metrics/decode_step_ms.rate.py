"""The engine's own decode time over its decode steps in the window
(``decode_s`` / ``decode_steps``, the engine's counters), in ms."""


def read(rec):
    c = rec.get("counters")
    if not c or not c["decode_steps"]:
        return None
    return 1e3 * c["decode_s"] / c["decode_steps"]
