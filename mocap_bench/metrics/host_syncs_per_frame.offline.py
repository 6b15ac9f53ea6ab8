"""Host synchronisations a frame: the trace's runtime calls that block the
host (stream, device and event synchronise, the synchronous copy; a
blocking read to the host is a copy and a stream synchronise, counted once),
over the window's frames."""


def read(t):
    return t.syncs / t.frames if t.frames and t.kernels else None
