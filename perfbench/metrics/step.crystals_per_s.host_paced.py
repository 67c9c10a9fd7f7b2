"""The window's training rate, real crystals of the steps completed over
the window (host clock), computed as ``train_crystals_per_s`` is: for a
cell whose rate the host's pace makes too unsteady to bound end to end.
Its ``moves`` names the cell's end-to-end metric only because one has to
be named; a faster step moves no memory."""


def read(ctx):
    w = ctx["window"]
    if not w["rows"] or w["seconds"] <= 0:
        return None
    return sum(r["crystals"] for r in w["rows"]) / w["seconds"]
