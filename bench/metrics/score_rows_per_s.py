"""score_rows_per_s: every query row scored in the window over the
window's seconds (host clock; the window ends with the card idle)."""


def read(ctx):
    w = ctx["window"]
    if w["window_s"] <= 0 or not w["rows"]:
        return None
    return w["rows"] / w["window_s"]
