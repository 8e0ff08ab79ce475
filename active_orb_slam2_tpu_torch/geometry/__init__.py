"""Geometry core: SE3 ops, the camera model and alignment (PyTorch)."""

from active_orb_slam2_tpu_torch.geometry.se3 import (  # noqa: F401
    quat_normalize, quat_mul, quat_conj, quat_rotate, quat_to_mat,
    mat_to_quat, se3_identity, se3_compose, se3_inverse, se3_apply, se3_exp,
    se3_retract, se3_to_mat44,
)
from active_orb_slam2_tpu_torch.geometry.projection import (  # noqa: F401
    CameraParams, backproject, project, project_stereo, in_frustum,
    predict_scale,
)
from active_orb_slam2_tpu_torch.geometry.horn import (  # noqa: F401
    horn_align, umeyama_alignment,
)
