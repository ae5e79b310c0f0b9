"""Scan operations and their CUDA kernels (PyTorch port of ``beer_tpu.ops``)."""
