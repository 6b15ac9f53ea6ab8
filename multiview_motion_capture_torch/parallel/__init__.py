from multiview_motion_capture_torch.parallel.mesh import make_mesh, pick_mesh_shape  # noqa: F401
from multiview_motion_capture_torch.parallel.sharded_association import (  # noqa: F401
    sharded_affinity,
)
from multiview_motion_capture_torch.parallel.train import sharded_train_step  # noqa: F401
