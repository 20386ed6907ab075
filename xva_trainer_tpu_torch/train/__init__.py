"""Training: mixed precision, the GAN optimisers and the v3 xVAPitch step."""
