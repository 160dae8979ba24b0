"""PyTorch/CUDA port of tpu1x for NVIDIA Hopper (H100).

The JAX package `tpu1x` stays the reference; this package imports torch and
never jax or tpu1x. Its kernels are hand-written CUDA C++ under `csrc/`,
built with nvcc at first use (`tpu1x_torch.kernels`).
"""
