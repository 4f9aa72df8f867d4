"""Image input and output."""
