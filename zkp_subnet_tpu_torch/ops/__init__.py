"""Field, curve, polynomial and MSM ops on torch tensors, with the CUDA
kernels (``kernels.py``) they launch on the card."""
