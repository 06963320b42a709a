"""Models of the port: ViT and conv backbones, ProbMap and SimCC heads,
their composition."""
