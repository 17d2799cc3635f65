"""evaluation package of the PyTorch port."""
