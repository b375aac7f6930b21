"""Image metrics and the per-frame evaluator."""
