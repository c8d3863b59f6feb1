"""The plain reference of manga-ocr-base: NumPy host preparation and a float32
PyTorch forward pass, written from the published architecture.  It imports
nothing of the program under test and nothing of JAX."""
