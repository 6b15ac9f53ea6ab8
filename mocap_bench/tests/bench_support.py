"""Support of the benchmark's CPU tests (`pytest mocap_bench/tests` from the
root of a checkout), imported first by each test file: the checkout's root
on the path, and the small cells.  The tests run the harness on the CPU at
small sizes (the port's plain kernels), never on a card."""
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# one torch thread: the tests share the machine with other work
torch.set_num_threads(1)

# a small cell of each kind for the CPU: the same paths at a size the CPU holds
SMALL = {
    "dome128-tri-offline": {"pipeline": {"n_views": 16, "assoc_clusters": 2, "max_people": 5},
                            "rig": {"views": 16}, "scene": {"people": 5},
                            "traffic": {"warmup_frames": 4, "chunk_frames": 4, "take_rate_fps": 4,
                                        "check_frames": 4}},
    "rig32-tri-online": {"pipeline": {"n_views": 8, "max_people": 4}, "rig": {"views": 8},
                         "scene": {"people": 4},
                         "traffic": {"warmup_frames": 4, "take_rate_fps": 4, "check_frames": 4}},
}


def small_cell(workload: str):
    """The cell as `BENCHMARK.json` names it, with the count of judged frames
    that a small window holds."""
    from mocap_bench import spec

    cell = spec.load_cell(workload)
    lim = dict(cell.limits["limits"], frames_judged={"min": 3})
    return cell._replace(limits={**cell.limits, "limits": lim})
