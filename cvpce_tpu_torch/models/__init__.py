"""Models: ResNet-50 + FPN + GLN detector, MACVGG embedder (torch)."""
