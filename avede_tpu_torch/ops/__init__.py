"""Preprocessing, hand-written CUDA kernels and their plain versions, scoring."""
