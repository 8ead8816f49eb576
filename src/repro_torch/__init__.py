"""PyTorch/CUDA port of the RPIQ quantize → pack → serve path.

A second package beside the JAX reference ``repro``; it imports torch and
numpy only. Entry points run on the CUDA card unless the caller passes
``device="cpu"``.
"""
