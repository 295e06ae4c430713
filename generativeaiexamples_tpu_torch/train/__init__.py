"""Training-side pieces of the PyTorch port (so far the LoRA adapter layout
the engine serves)."""
