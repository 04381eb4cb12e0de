"""nn.Modules of the SD1.x serving slice, with diffusers parameter names."""
