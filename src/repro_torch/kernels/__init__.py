"""repro_torch.kernels — hand-written CUDA kernels and their wrappers.

``sc_fused`` (fused bit-exact SC matmul), ``paged_attention`` (fused
paged attention, exact or SC-sampled QK^T) and ``sc_mac`` (fused
moment SC matmul, noise streamed in or made in the kernel) wrap
``csrc/*.cu``, built and loaded by ``cuda_lib``; ``sc_mul`` holds the
shared Horner-ladder and pop-count helpers of the plain versions.
"""
