"""Detector modules: VFE, DSVT backbone, BEV ResNet, CenterHead, end to end."""
