"""Serving: the forest inference server (`engine.ForestServer`)."""
