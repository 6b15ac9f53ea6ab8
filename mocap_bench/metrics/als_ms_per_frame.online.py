"""Device ms a frame of the ALS kernel (`csrc/als.cu`: B1 or B3), from its
kernel records."""


def read(t):
    ms = t.kernel_seconds("als_kernel") * 1e3
    return ms / t.frames if t.frames and ms > 0 else None
