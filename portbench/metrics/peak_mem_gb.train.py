"""The allocator's peak during the window (``max_memory_allocated`` after
a reset at its start), in GB (1e9 bytes)."""


def read(rec):
    b = rec.get("mem_peak_window_bytes", 0)
    return b / 1e9 if b else None
