"""Frames handed in during the window, over the window's seconds (the
window ends with ``System.flush()`` and a synchronize)."""


def read(run):
    return run.n_window / run.window_s
