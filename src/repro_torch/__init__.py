"""E2LSH on Storage in PyTorch, with hand-written CUDA kernels for NVIDIA
Hopper (``sm_90a``). Entry points run on the CUDA device unless the caller
passes ``device="cpu"``, where each kernel's plain PyTorch version runs."""
