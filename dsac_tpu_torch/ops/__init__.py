"""Pipeline ops (port of dsac_tpu/ops): stratified sampling, two-phase
hypothesis sampling, soft-inlier scoring, selection, and the CUDA kernels
with their plain PyTorch versions:

  p3p_cuda.p3p_solve              <- ops/p3p_pallas.py:_p3p_kernel
  diffmap_cuda.soft_inlier_scores <- ops/diffmap_pallas.py:_score_kernel
  diffmap_cuda.diffmaps           <- ops/diffmap_pallas.py:_diffmap_kernel
  gn_cuda.refine_pose_fused       <- ops/gn_pallas.py:_refine_kernel
  gn_cuda.refine_init_sensitive   <- ops/gn_pallas.py:
                                     make_init_sensitivity_refiner (its
                                     backward: one more refine launch)
  gn_cuda.irls_stats              <- ops/gn_pallas.py:_irls_stats_kernel
"""
