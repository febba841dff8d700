"""PyTorch/CUDA port of vit_colmap_tpu for NVIDIA Hopper (H100)."""
