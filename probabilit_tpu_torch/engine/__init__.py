"""Planning, the plain PyTorch executor, the CUDA executor and sampling."""
