"""Models of the port: ViT backbone, ProbMap head, their composition."""
