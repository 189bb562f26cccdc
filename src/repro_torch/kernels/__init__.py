"""Hand-written Hopper kernels for the TPU kernels of ``repro.kernels``.

Each kernel's CUDA source lives in ``csrc/<name>.cu`` and its ctypes
wrapper in ``<name>.py``; ``ref.py`` holds the plain PyTorch versions and
``ops.py`` dispatches: the kernel for a CUDA tensor, the plain version
for a CPU tensor."""
