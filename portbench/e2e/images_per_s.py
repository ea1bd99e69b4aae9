"""Images whose results the loop received inside the window, over the
time from the window's start to the last of those results (the host
clock; the window opens at a completed result, so the time holds whole
requests only)."""


def read(window, setup_s):
    if not window.requests:
        return None
    return len(window.requests) / (window.t_last - window.t0)
