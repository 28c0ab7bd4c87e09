"""Modeling: the backbones (DLA, ResNet, DenseNet, MNASNet, ShuffleNet) + FPN,
RPN, box and cube heads, CubeRCNN."""
