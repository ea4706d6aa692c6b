"""monolith_tpu_torch: the PyTorch/CUDA port of monolith_tpu for one NVIDIA H100.

A second package beside the JAX one, which stays the reference. It imports
torch and numpy, never JAX or anything of `monolith_tpu`. Its entry points
run on the card unless the caller passes `device="cpu"`.
"""
