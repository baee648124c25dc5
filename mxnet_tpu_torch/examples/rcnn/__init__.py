"""Two-stage detection on synthetic scenes (reference: example/rcnn)."""
