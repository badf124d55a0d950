"""Hand-written Hopper kernels (CUDA C++, sm_90a) and their plain versions."""
