"""Modeling: DLA-34 + FPN backbone, RPN, box and cube heads, CubeRCNN."""
