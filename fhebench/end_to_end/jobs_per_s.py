"""Jobs completed in the window ÷ the time from the window's start to the last completion."""


def read(w):
    span = w.last_done - w.start
    return len(w.latencies) / span if w.latencies and span > 0 else None
