"""Ops of the port: KNN and the fused Swin sublayers (plain PyTorch on the
CPU, hand-written Hopper kernels on a CUDA tensor)."""
