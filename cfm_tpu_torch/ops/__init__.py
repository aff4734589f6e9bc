"""Kernels and their plain PyTorch versions (counterpart of ``cfm_tpu/ops``).

Each module that holds a hand-written kernel keeps its plain version beside
it: a CPU tensor runs the plain version, a CUDA tensor launches the kernel or
raises. Kernels are built at first launch (``_build``), never at import.
"""
