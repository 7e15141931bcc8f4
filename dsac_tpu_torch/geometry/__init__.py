"""Pose math, minimal solver, Gauss-Newton refinement and pose errors
(port of dsac_tpu/geometry).  Functions broadcast over leading batch
dimensions, like the reference under vmap."""

from dsac_tpu_torch.geometry.rotation import (
    angular_distance_deg, hat, so3_exp, so3_log,
)
from dsac_tpu_torch.geometry.pose import (
    Pose, compose, identity_pose, invert, pose_from_vec6, pose_to_vec6,
    transform,
)
from dsac_tpu_torch.geometry.projection import (
    project, reprojection_errors, transform_to_eye,
)
from dsac_tpu_torch.geometry.loss import (
    MAX_LOSS, expected_max_loss, is_correct, max_loss, pose_errors,
)
from dsac_tpu_torch.geometry.p3p import solve_pnp_minimal
from dsac_tpu_torch.geometry.gn import (gn_pnp, implicit_refine_step,
                                        refine_pose)
