"""threedod_torch: PyTorch/CUDA port of threedod (supervised Cube R-CNN inference and training).

Imports torch and numpy only; nothing here imports jax or the threedod package.
"""
