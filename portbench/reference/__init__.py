"""Plain PyTorch references, one module per model family. They import
neither jax, gumbi_tpu nor gumbi_tpu_torch, and take nothing the port made."""
