"""PyTorch/CUDA port of the LP (layer parallelism) system.

A second package beside the JAX reference: the same configs, LP plans and
model functions, with each TPU kernel on the serving path rewritten by hand
for Hopper (``repro_torch.kernels``). It imports neither JAX nor the JAX
package. See README.md for what is ported so far.
"""
