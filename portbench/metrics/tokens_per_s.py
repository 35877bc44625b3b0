"""Training tokens a second: every token of every step completed in the
window, over the window's seconds."""


def read(run):
    if run.window_s <= 0 or not run.records:
        return None
    return sum(r["work"] for r in run.records) / run.window_s
