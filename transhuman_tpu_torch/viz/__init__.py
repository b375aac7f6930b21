"""Free-viewpoint frame writing."""
