"""Pipeline ops (port of dsac_tpu/ops): stratified sampling, two-phase
hypothesis sampling, soft-inlier scoring, selection, and the three CUDA
kernels of the serve path with their plain PyTorch versions:

  p3p_cuda.p3p_solve              <- ops/p3p_pallas.py:_p3p_kernel
  diffmap_cuda.soft_inlier_scores <- ops/diffmap_pallas.py:_score_kernel
  gn_cuda.refine_pose_fused       <- ops/gn_pallas.py:_refine_kernel
"""
