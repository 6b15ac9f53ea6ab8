"""Kernel launches a frame: the trace's kernel records over the window's
frames (copies and memsets not counted)."""


def read(t):
    return t.kernel_count() / t.frames if t.frames and t.kernels else None
