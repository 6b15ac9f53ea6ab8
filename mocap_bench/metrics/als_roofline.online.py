"""The ALS kernel's share of its roofline, %: its least time over its device
time.  The least time is max(bytes / 3.35 TB/s, f32 ops / 67 TFLOP/s), the
ops counted from the problem's shape (side n, rank r) and the iterations
that `FrameOutput.als_iters` reports over the window, the bytes from each
launch's problems (`roofline.py`)."""
from mocap_bench import roofline


def read(t):
    dev_s = t.kernel_seconds("als_kernel")
    c = t.counters
    if dev_s <= 0 or "als_iters" not in c:
        return None
    return roofline.als_roofline_pct(c["als_iters"], t.kernel_count("als_kernel"), dev_s,
                                     int(c["als_n"]), int(c["als_rank"]),
                                     int(c["als_problems"]))
