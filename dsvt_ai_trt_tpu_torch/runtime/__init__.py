"""Inference runtime: the engine and the frame loop."""
