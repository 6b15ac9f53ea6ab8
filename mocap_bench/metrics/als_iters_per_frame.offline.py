"""ALS iterations a frame: `FrameOutput.als_iters` (the sum over a frame's
cluster problems) over the window's frames; a count of the program's own."""


def read(t):
    it = t.counters.get("als_iters")
    return it / t.frames if t.frames and it is not None else None
